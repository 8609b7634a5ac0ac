"""Subpackage of the PyTorch port (mirrors the reference package's layout)."""
