"""Host side of the decode tile loop (``csrc/decode_attention.cuh``) that
the paged, branch-decode and flash kernels share: the row tiling, the
split-KV plan and the width and load path a head dim runs at.

A block holds ``ROWS`` query rows (G heads x tokens) of one kv head;
the flash kernel gives an item's rows to blocks of ``WIDE_ROWS`` rows
when it has at least that many (prefill, cache-less and bidirectional
calls), so that 64 rows share each K/V tile the block reads.
When those blocks would leave SMs idle, the key axis is split: the plan
is a pure function of shapes the host knows (``n_max * ps`` for paged,
``Sp + branches * Ss`` for branch decode, the ring's S for flash), never
of ``lens`` or key positions, which live on the card.  The splits of a
(row tile, kv head) run as one thread-block cluster and merge through
shared memory inside the launch, so a split call needs no scratch and
keeps no state.

Head dims 1-256.  A call whose head dim is one of ``HEAD_DIMS``, with
every row a multiple of 16 bytes and every tensor 16-byte aligned, takes
the aligned path: its tiles load by 16-byte ``cp.async`` at the compiled
width hd.  Any other head dim, or storage off a 16-byte boundary, takes
the ragged path (``head_dim_path``): the loop runs at the smallest of
``RAGGED_WIDTHS`` not below hd, with hd the rows' stride in device
memory, the tiles' columns past hd zero, 4-byte word copies (a bf16 row
starting 2 bytes past a word is shifted into place once it lands) and
guarded stores.  granite-moe-3b-a800m's draft (3 heads of 85: rows of
170 bytes in bf16) runs at 96.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

ROWS = 16                 # query rows per block: one m16 tensor-core tile
WIDE_ROWS = 64            # query rows of a wide block: a 16-row tile a warp
SPLIT_ALIGN = 64          # keys the block's four warps walk in one pass
MIN_SPLIT_KEYS = 128      # fewer keys per split do not repay the merge
MAX_SPLITS = 8            # a cluster's portable size
# the aligned path's head dims: every attention head dim of the repo's
# configs and of their draft() variants but granite-moe's draft's 85
HEAD_DIMS = (16, 32, 64, 80, 128, 144, 160, 256)
# the ragged path's compiled widths: 96 holds 85 with 11 zero columns (128
# would do 51% more tile work); 80 and 144 are left out, so a head dim runs
# at the next width up, to keep the build's template instances few
RAGGED_WIDTHS = (16, 32, 64, 96, 128, 160, 256)
MAX_HEAD_DIM = 256

_SM_COUNT: Dict[int, int] = {}


def row_tiles(rows: int, per: int = ROWS) -> int:
    """Blocks of ``per`` query rows over ``rows`` rows (G heads x
    tokens)."""
    return -(-rows // per)


def plan_splits(units: int, max_keys: int, sm_count: int
                ) -> Tuple[int, int]:
    """(n_split, split_len) for ``units`` blocks (row tiles x kv heads)
    over at most ``max_keys`` keys each: as many splits as the
    ``sm_count`` SMs hold at one block each, of at least
    ``MIN_SPLIT_KEYS`` keys (a multiple of ``SPLIT_ALIGN``).
    ``max_keys`` is a bound (a serve's tables are as wide as its longest
    request), so a split the rows do not reach costs its merge for
    nothing: a grid that covers half the SMs is not split."""
    max_keys = max(int(max_keys), 1)
    n = 1
    if units > 0:
        n = min(sm_count // units, max_keys // MIN_SPLIT_KEYS, MAX_SPLITS)
    if n <= 1:
        return 1, max_keys
    split_len = -(-max_keys // n)
    split_len = -(-split_len // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-max_keys // split_len), split_len


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def check_head_dim(name: str, hd: int) -> None:
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {hd} is outside 1-{MAX_HEAD_DIM}")


def head_dim_path(name: str, hd: int, *tensors: torch.Tensor
                  ) -> Tuple[int, bool]:
    """(width, ragged): the compiled width a call of head dim ``hd`` over
    ``tensors`` (its q, K/V and gradient inputs) runs at, and whether it
    takes the ragged load path.  Aligned: hd is one of ``HEAD_DIMS`` and
    every tensor's rows are whole 16-byte chunks from a 16-byte aligned
    start, so the tiles load by 16-byte ``cp.async`` (width = hd).
    Ragged: any other hd, or storage off a 16-byte boundary; width is the
    smallest of ``RAGGED_WIDTHS`` not below hd.  Reads no device memory.
    Raises outside 1-256."""
    check_head_dim(name, hd)
    if hd in HEAD_DIMS and all((hd * x.element_size()) % 16 == 0
                               and x.data_ptr() % 16 == 0 for x in tensors):
        return hd, False
    return next(w for w in RAGGED_WIDTHS if w >= hd), True
