"""Meshes (port of ``repro.launch.mesh``, DESIGN.md §7.10): the serving
and training meshes as ``torch.distributed`` process groups, and the
shape-only production meshes of the dry run.

A ``(dp, tp)`` mesh is ``dp * tp`` processes, one per mesh
position ``(d, t)``, rank ``d * tp + t``.  Every rank runs the same host
loop (pool accounting, scheduler, PRNG keys) over its shard of the weights
and caches; the tensor-parallel forward issues its collectives over the
rank's "model" group, the dense backend's data parallelism over its
"data" group (``MeshAxis``), and every issued collective is counted in
the mesh's ``Census`` (``sharding.hlo_analysis``).

The backend and each rank's device are explicit arguments of
``make_serving_mesh`` and ``spawn``: NCCL with one card per rank, or gloo
(on the CPU, or for ranks that share a card).  Nothing switches backend
or device on its own.  ``spawn`` starts the ranks with the *spawn* start
method (CUDA cannot fork), runs a named function of this package in each
and returns their results; a failed rank, or one silent past the
timeout, fails the caller.

Under autograd (the training mesh, ``launch.steps``) the axes' collectives
carry gradients: ``all_reduce`` sums a row-split product's partials and
passes the gradient through unchanged, ``copy_in`` (the identity) sums
the gradient of a replicated input that enters a split product, and
``fsdp_gather`` gathers a weight's FSDP blocks and reduce-scatters its
gradient back.  Every collective, forward or backward, is counted in the
``Census`` with its bytes.

``make_production_mesh`` / ``make_host_mesh`` are shape-only meshes
(``ShapeMesh``: a ``.shape`` dict, which the rules take): the dry run
(``launch.dryrun``) lays out and costs programs on them and allocates
nothing.  The hardware constants below are the H100's, each with its
source; the roofline's collective term takes the slowest link a group
spans (NVLink within an 8-GPU node, the node's InfiniBand across
nodes).
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.sharding.hlo_analysis import Census


def parse_mesh_arg(arg: str):
    """Parse a ``--mesh dp,tp`` CLI value into ``(dp, tp)``.

    Raises ValueError with an actionable message on anything that isn't
    two positive comma-separated integers (a bare ``tp`` is accepted as
    shorthand for ``1,tp`` — tensor parallelism is the serving default
    axis)."""
    parts = [p.strip() for p in str(arg).split(",")]
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        raise ValueError(
            f"--mesh expects 'dp,tp' (two comma-separated integers), "
            f"got {arg!r}")
    if len(dims) == 1:
        dims = [1, dims[0]]
    if len(dims) != 2 or any(d < 1 for d in dims):
        raise ValueError(
            f"--mesh expects 'dp,tp' with dp >= 1 and tp >= 1, got {arg!r}")
    return dims[0], dims[1]


def validate_serving_mesh(dp: int, tp: int, *, configs=(),
                          n_devices: int = 0, device="cuda") -> None:
    """Reject meshes that cannot shard losslessly.

    ``configs``: ModelConfigs that will run under the mesh (target AND
    draft) — ``tp`` must divide each one's attention-head count, as the
    reference requires; each rank then holds the whole KV heads its query
    heads read (``sharding.rules`` exception (a)).  ``n_devices`` must
    cover dp*tp; it defaults to ``torch.cuda.device_count()`` for a CUDA
    ``device``, while CPU ranks are processes and take no device count.
    Raises ValueError with an actionable message; dp is never checked
    against the batch — an odd batch degrades to replication, it doesn't
    break."""
    check = n_devices > 0
    if not check and torch.device(device).type == "cuda":
        n_devices, check = torch.cuda.device_count(), True
    if check and dp * tp > n_devices:
        raise ValueError(
            f"--mesh {dp},{tp} needs {dp * tp} devices but only "
            f"{n_devices} are visible; on the CPU run the {dp * tp} ranks "
            f"as gloo processes with --device cpu")
    for cfg in configs:
        heads = getattr(cfg, "num_heads", 0)
        if heads and heads % tp != 0:
            raise ValueError(
                f"--mesh {dp},{tp}: tp={tp} does not divide "
                f"{cfg.name!r}'s {heads} attention heads; pick tp in "
                f"{[t for t in range(1, heads + 1) if heads % t == 0]}")


# ---------------------------------------------------------------------------
# shape-only production meshes and the H100's constants
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh of axis sizes only (no devices, no processes)."""
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """16x16 single-pod (256 GPUs) or 2x16x16 two-pod (512 GPUs) mesh,
    axes ("data", "model") / ("pod", "data", "model"), shape only."""
    if multi_pod:
        return ShapeMesh({"pod": 2, "data": 16, "model": 16})
    return ShapeMesh({"data": 16, "model": 16})


def make_host_mesh() -> ShapeMesh:
    """The 1x1 mesh of one device, shape only."""
    return ShapeMesh({"data": 1, "model": 1})


# NVIDIA H100 SXM5 80GB (the card of this repo's chip runs): the H100
# datasheet's dense BF16 tensor-core peak and HBM3 bandwidth
PEAK_FLOPS_BF16 = 989e12     # FLOP/s per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
# NVLink 4 (18 links) inside an 8-GPU HGX node: 900 GB/s per GPU in both
# directions, 450 GB/s in one (the datasheet's NVLink figure)
NVLINK_BW = 450e9            # bytes/s per GPU, one direction
# across nodes: one 400 Gb/s NDR InfiniBand adapter per GPU (the HGX
# H100 reference design), 50 GB/s in one direction
IB_BW = 50e9                 # bytes/s per GPU, one direction
GPUS_PER_NODE = 8


def group_link_bw(mesh, axis) -> float:
    """The slowest link a collective over ``axis`` (a name, a tuple of
    names, or "world" for every axis) crosses: ranks are laid out
    row-major over the mesh's axes (the last fastest), 8 to a node, so a
    group whose members' ranks span more than one node goes over
    InfiniBand.  (At 16x16 a 16-wide "model" group spans two nodes.)"""
    names = list(mesh.shape)
    axes = names if axis == "world" else (
        list(axis) if isinstance(axis, tuple) else [axis])
    span, stride = 1, 1
    for a in reversed(names):
        if a in axes:
            span += stride * (mesh.shape[a] - 1)
        stride *= mesh.shape[a]
    return NVLINK_BW if span <= GPUS_PER_NODE else IB_BW


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


@dataclasses.dataclass
class MeshAxis:
    """One rank's view of one mesh axis: its ``size``, the rank's
    ``index`` along it, the process group of the ranks that share every
    other coordinate, and the census its collectives are counted in.  A
    collective over an axis of size 1 is the identity and issues
    nothing."""
    name: str
    size: int
    index: int
    ranks: List[int]
    group: Any
    census: Census

    def _all_reduce(self, x: torch.Tensor, op=None) -> torch.Tensor:
        self.census.record("all-reduce", self.size, _nbytes(x))
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=self.group)
        return x

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the axis: a row-split product's partial sums
        (under autograd a new tensor, the gradient passed through
        unchanged; else ``x`` reduced in place, or a new contiguous
        tensor when ``x`` is not contiguous)."""
        if self.size == 1:
            return x
        if _needs_grad(x):
            return _AllReduce.apply(x, self)
        return self._all_reduce(x.contiguous())

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max of ``x`` over the axis (a new tensor; no
        gradient)."""
        if self.size == 1:
            return x
        return self._all_reduce(x.detach().clone().contiguous(),
                                dist.ReduceOp.MAX)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself, whose gradient is summed over the axis: a
        replicated input entering a split product (each rank's gradient
        is the part its block contributes)."""
        if self.size == 1 or not _needs_grad(x):
            return x
        return _CopyIn.apply(x, self)

    def _all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self.census.record("all-gather", self.size, self.size * _nbytes(x))
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The axis's blocks of ``x`` concatenated along ``dim``, in index
        order (no gradient)."""
        if self.size == 1:
            return x
        return self._all_gather(x.detach(), dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's block along ``dim`` of the sum of ``x`` over the
        axis (a new tensor)."""
        if self.size == 1:
            return x
        parts = [p.contiguous() for p in x.chunk(self.size, dim=dim)]
        out = torch.empty_like(parts[0])
        self.census.record("reduce-scatter", self.size, _nbytes(x))
        dist.reduce_scatter(out, parts, group=self.group)
        return out

    def fsdp_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """A weight's FSDP blocks gathered along ``dim``; under autograd
        its gradient is reduce-scattered back into the rank's block (each
        rank's gradient comes from its own rows of the batch)."""
        if self.size == 1:
            return x
        if _needs_grad(x):
            return _FsdpGather.apply(x, self, dim)
        return self._all_gather(x, dim)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """``x`` of the rank at index ``src`` on every rank of the axis
        (``x`` is overwritten in place elsewhere)."""
        if self.size == 1:
            return x
        self.census.record("broadcast", self.size, _nbytes(x))
        dist.broadcast(x, src=self.ranks[src], group=self.group)
        return x


class _AllReduce(torch.autograd.Function):
    """Forward: the sum over the axis; backward: the identity (every rank
    backpropagates the same loss through the sum)."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis._all_reduce(x.detach().clone().contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    """Forward: the identity; backward: the sum over the axis."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._all_reduce(g.clone().contiguous()), None


class _FsdpGather(torch.autograd.Function):
    """Forward: all-gather along ``dim``; backward: reduce-scatter."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis._all_gather(x.detach(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_scatter(g, ctx.dim), None, None


@dataclasses.dataclass
class ServingMesh:
    """A ``(dp, tp)`` mesh as one rank sees it (the serving engines, the
    production steps and the training step run on it)."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    rank: int
    world: int
    backend: str
    device: torch.device
    axes: Dict[str, MeshAxis]
    census: Census

    def axis(self, name: str) -> MeshAxis:
        return self.axes[name]

    @property
    def tp(self) -> Optional[MeshAxis]:
        """The "model" axis when it splits anything, else None (the
        forward then issues no collective)."""
        ax = self.axes["model"]
        return ax if ax.size > 1 else None

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over every rank of the mesh, in place (no
        gradient)."""
        if self.world == 1:
            return x
        self.census.record("all-reduce", self.world, _nbytes(x))
        dist.all_reduce(x)
        return x

    def agree(self, value: int) -> bool:
        """Whether every rank passed the same ``value`` (an integer below
        2^23, exact in float32): one all-reduce of (v, -v) with MAX over
        the whole mesh."""
        if self.world == 1:
            return True
        t = torch.tensor([float(value), -float(value)], dtype=torch.float32,
                         device=self.device)
        self.census.record("all-reduce", self.world, _nbytes(t))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t[0].item() == -t[1].item())


def make_serving_mesh(dp: int, tp: int, *, backend: str,
                      devices: Sequence[Any], init_method: str, rank: int,
                      timeout_s: float = 600.0) -> ServingMesh:
    """The ``(dp, tp)`` serving mesh over axes ("data", "model") for this
    process: joins the ``dp * tp``-rank default process group of
    ``backend`` through ``init_method`` as ``rank``, builds the "model"
    and "data" subgroups, and binds ``devices[rank]`` (a CUDA device
    becomes the current one).  ``timeout_s`` bounds every collective, so
    a dead peer raises instead of hanging."""
    world = dp * tp
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a {dp}x{tp} mesh")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    d, t = divmod(rank, tp)
    census = Census()
    # every rank creates every group, in the same order
    model_groups = [[dd * tp + tt for tt in range(tp)] for dd in range(dp)]
    data_groups = [[dd * tp + tt for dd in range(dp)] for tt in range(tp)]
    axes = {}
    for name, groups, mine, idx in (("model", model_groups, d, t),
                                    ("data", data_groups, t, d)):
        handles = [dist.new_group(g) for g in groups]
        axes[name] = MeshAxis(name, len(groups[mine]), idx, groups[mine],
                              handles[mine], census)
    return ServingMesh(shape={"data": dp, "model": tp},
                       coords={"data": d, "model": t}, rank=rank,
                       world=world, backend=backend, device=device,
                       axes=axes, census=census)


def probe_collectives(mesh: ServingMesh, _payload=None) -> Dict[str, str]:
    """Rank target: which collectives the mesh's backend takes on tensors
    of the mesh's device, by dtype — all_reduce, all_gather, broadcast
    and reduce_scatter over the whole mesh in float32, bfloat16 and
    int32.  Returns "ok",
    "wrong" (it ran but gave another value) or the error's first line,
    by ``"collective dtype"``."""
    out: Dict[str, str] = {}
    n, r = mesh.world, mesh.rank
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        name = str(dt).split(".")[-1]

        def run(kind):
            x = torch.full((4,), r + 1, dtype=dt, device=mesh.device)
            if kind == "all_reduce":
                dist.all_reduce(x)
                return x.tolist() == [n * (n + 1) // 2] * 4
            if kind == "all_gather":
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x)
                return [p[0].item() for p in parts] == list(range(1, n + 1))
            if kind == "reduce_scatter":
                out1 = torch.empty((4,), dtype=dt, device=mesh.device)
                dist.reduce_scatter(out1, [x.clone() for _ in range(n)])
                return out1.tolist() == [n * (n + 1) // 2] * 4
            dist.broadcast(x, src=n - 1)
            return x.tolist() == [n] * 4
        for kind in ("all_reduce", "all_gather", "broadcast",
                     "reduce_scatter"):
            try:
                out[f"{kind} {name}"] = "ok" if run(kind) else "wrong"
            except Exception as e:          # the probe's answer, not a bug
                out[f"{kind} {name}"] = str(e).splitlines()[0][:120]
    return out


# ---------------------------------------------------------------------------
# spawning the ranks
# ---------------------------------------------------------------------------

def _resolve(target: str):
    mod, _, fn = target.partition(":")
    if not mod.startswith("repro_torch."):
        raise ValueError(f"rank target {target!r} must live in repro_torch")
    return getattr(importlib.import_module(mod), fn)


def _rank_main(rank: int, dp: int, tp: int, target: str, payload: Any,
               backend: str, devices: Sequence[Any], init_method: str,
               timeout_s: float, threads: int, results) -> None:
    """A rank's process: build the mesh, run ``target(mesh, payload)``,
    report its result (or its traceback) on ``results``."""
    try:
        if threads > 0:
            torch.set_num_threads(threads)
        mesh = make_serving_mesh(dp, tp, backend=backend, devices=devices,
                                 init_method=init_method, rank=rank,
                                 timeout_s=timeout_s)
        out = _resolve(target)(mesh, payload)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(dp: int, tp: int, target: str, payload: Any = None, *,
          backend: str, devices: Sequence[Any],
          init_method: Optional[str] = None, timeout_s: float = 600.0,
          threads: int = 1) -> List[Any]:
    """Run ``target`` ("repro_torch.module:function", called as
    ``function(mesh, payload)``) on every rank of a ``(dp, tp)`` mesh,
    each in a fresh process, and return the results in rank order.

    ``init_method`` defaults to a ``file://`` store in a fresh temporary
    directory; ``threads`` > 0 sets each rank's intra-op thread count.
    Results must pickle without tensors (plain Python or numpy).  A rank
    that raises fails the call with its traceback; a rank that exits
    without a result, or a mesh not done within ``timeout_s``, fails it
    too, and every rank still running is killed."""
    import torch.multiprocessing as mp
    world = dp * tp
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a {dp}x{tp} mesh")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="mesh-")
        init_method = "file://" + os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, dp, tp, target, payload, backend,
                               list(devices), init_method, timeout_s,
                               threads, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = time.time() + timeout_s
    try:
        while len(out) < world:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.time() > deadline:
                    late = sorted(set(range(world)) - set(out))
                    raise TimeoutError(
                        f"{dp}x{tp} mesh: ranks {late} gave no result "
                        f"within {timeout_s:.0f} s")
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"{dp}x{tp} mesh: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(
                    f"{dp}x{tp} mesh: rank {rank} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        if tmp is not None:
            for f in os.listdir(tmp):
                os.remove(os.path.join(tmp, f))
            os.rmdir(tmp)
    return [out[r] for r in range(world)]
