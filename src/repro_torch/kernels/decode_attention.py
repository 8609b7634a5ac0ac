"""Host side of the decode tile loop (``csrc/decode_attention.cuh``) that
the paged, branch-decode and flash kernels share: the row tiling, the
split-KV plan and the head dims the loop is built for.

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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

ROWS = 16                 # query rows per block: one m16 tensor-core tile
WIDE_ROWS = 64            # query rows of a wide block: a 16-row tile a warp
SPLIT_ALIGN = 64          # keys the block's four warps walk in one pass
MIN_SPLIT_KEYS = 128      # fewer keys per split do not repay the merge
MAX_SPLITS = 8            # a cluster's portable size
# the head dims of the repo's configs and of their draft() variants that
# a 16-byte row holds (granite-moe's draft, 85, is refused)
HEAD_DIMS = (16, 32, 64, 80, 128, 144, 160, 256)

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
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} is not one of {HEAD_DIMS}")
