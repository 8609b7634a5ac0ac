"""Mesh layout of the port (port of ``repro.sharding``): the partition
rules (``rules``) and the census of the collectives the tensor-parallel
forward issues (``hlo_analysis``)."""
