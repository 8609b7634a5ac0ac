"""Wrapper of the CUDA shared-prefix branch decode kernel
(``csrc/branch_attention.cu``), the port of
``repro.kernels.ops.branch_decode_attention`` (Eq. 8: two passes of the
Pallas flash kernel merged by (m, l)), fused into one online softmax.

Layout as in the reference: q (k, Tq, H, hd), one row per branch;
prefix_k/v (1, Sp, KV, hd), stored once and shared by every branch;
prefix_pos (1, Sp); suffix_k/v (k, Ss, KV, hd); suffix_pos (k, Ss);
q_pos (k, Tq); positions int32, -1 marking an invalid slot.  Query t of
branch b sees a key when its position is >= 0 and <= q_pos[b, t].  The
kernel's tile loop (``csrc/decode_attention.cuh``) is the paged and
flash kernels': one block holds the query rows of every branch of its
16-row tile for one kv head, so the prefix is read once per kv head; the
key axis is split when those blocks would leave SMs idle.  A query that
sees no key gets zeros.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as DA


def max_branches_per_tile(nb: int, Tq: int, G: int) -> int:
    """The most branches whose rows one 16-row tile holds (rows ordered
    branch, token, head): the suffixes a block may walk."""
    rows, per = nb * Tq * G, Tq * G
    return max((min(r0 + DA.ROWS, rows) - 1) // per - r0 // per + 1
               for r0 in range(0, rows, DA.ROWS))


def split_plan(nb: int, Tq: int, H: int, KV: int, Sp: int, Ss: int,
               sm_count: int) -> Tuple[int, int]:
    """(n_split, split_len) of a call: row tiles x kv heads blocks, the
    key axis planned from the prefix and the suffixes of the fullest row
    tile."""
    G = H // KV
    return DA.plan_splits(DA.row_tiles(nb * Tq * G) * KV,
                          Sp + max_branches_per_tile(nb, Tq, G) * Ss,
                          sm_count)


def branch_decode_attention(q: torch.Tensor, prefix_k: torch.Tensor,
                            prefix_v: torch.Tensor, prefix_pos: torch.Tensor,
                            suffix_k: torch.Tensor, suffix_v: torch.Tensor,
                            suffix_pos: torch.Tensor, q_pos: torch.Tensor, *,
                            cap: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel (one launch, split-KV included) on CUDA tensors;
    returns (k, Tq, H, hd) in q's dtype.  Non-contiguous inputs are
    copied, positions cast to int32; raises on a CPU tensor, a bad
    dtype/shape/head dim or a launch error."""
    nb, T, H, hd = q.shape
    _, Sp, KV, hd_p = prefix_k.shape
    _, Ss, _, _ = suffix_k.shape
    args = {"q": q, "prefix_k": prefix_k, "prefix_v": prefix_v,
            "prefix_pos": prefix_pos, "suffix_k": suffix_k,
            "suffix_v": suffix_v, "suffix_pos": suffix_pos, "q_pos": q_pos}
    for name, x in args.items():
        if x.device.type != "cuda":
            raise ValueError(f"branch_decode_attention: {name} is on "
                             f"{x.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"branch_decode_attention: dtype {q.dtype} "
                        "unsupported")
    for x in (prefix_k, prefix_v, suffix_k, suffix_v):
        if x.dtype != q.dtype:
            raise TypeError("branch_decode_attention: q and K/V differ in "
                            "dtype")
    if (prefix_k.shape[0] != 1 or prefix_v.shape != prefix_k.shape
            or suffix_k.shape != (nb, Ss, KV, hd)
            or suffix_v.shape != suffix_k.shape or hd_p != hd or H % KV):
        raise ValueError("branch_decode_attention: shape mismatch "
                         f"q{tuple(q.shape)} prefix{tuple(prefix_k.shape)} "
                         f"suffix{tuple(suffix_k.shape)}")
    for name, x, shape in (("prefix_pos", prefix_pos, (1, Sp)),
                           ("suffix_pos", suffix_pos, (nb, Ss)),
                           ("q_pos", q_pos, (nb, T))):
        if tuple(x.shape) != shape or x.dtype.is_floating_point:
            raise ValueError(f"branch_decode_attention: {name} must be "
                             f"integer {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    q, prefix_k, prefix_v, suffix_k, suffix_v = (
        x.contiguous() for x in (q, prefix_k, prefix_v, suffix_k, suffix_v))
    prefix_pos, suffix_pos, q_pos = (
        x.to(torch.int32).contiguous()
        for x in (prefix_pos, suffix_pos, q_pos))
    width, ragged = DA.head_dim_path("branch_decode_attention", hd, q,
                                     prefix_k, prefix_v, suffix_k, suffix_v)
    L = build.lib()
    out = torch.empty_like(q)
    if nb == 0 or T == 0:
        return out
    n_split, split_len = split_plan(nb, T, H, KV, Sp, Ss,
                                    DA.sm_count(q.device))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = L.repro_branch_attention(
            q.data_ptr(), prefix_k.data_ptr(), prefix_v.data_ptr(),
            prefix_pos.data_ptr(), suffix_k.data_ptr(), suffix_v.data_ptr(),
            suffix_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
            nb, T, Sp, Ss, H, KV, hd, width, int(ragged), n_split, split_len,
            float(cap) if cap is not None else 0.0, 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16), stream)
    build.check(rc, "branch_decode_attention")
    build.LAUNCHES["branch_decode_attention"] += 1
    return out
