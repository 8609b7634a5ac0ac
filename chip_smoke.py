#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):
  1. build   — compile the CUDA kernels of src/repro_torch/csrc with nvcc
               (one process per source, in parallel); print the build time
               and the card's name and power limit.
  2. kernels — each kernel against its plain PyTorch version on the card at
               the shapes the main path gives it (full-width LLaMA-68M/7B
               and the tiny committed pair), with the tolerance stated per
               check; median device times (CUDA events) beside the least
               time the card could take (bound), a library call where
               one exists, the split count of the decode kernels (paged,
               branch) and the timing floor (a one-element add and a
               10 MB copy under the same timer); besides the main path's
               shapes, page tables as wide as a serve's, a long row at
               B = 1 and a 2048-key shared prefix, and the parallel-draft
               frames of phase 13 (flash with q_ctx clamped below q_pos on
               the slot columns and slot keys at -1; paged with lens =
               q_start + real tokens < q_start + T), and phase 14's
               suffix prefill (paged: a rung of queries from the cached
               length on over tables that share the cached run's pages,
               7B bf16 and tiny f32; the ring scan at falcon's width from
               a restored slot at p0 = 256, T = 16 and 32).  The shared-prefix
               branch decode and the single-request verify lie on no
               engine path, in either package: their path is the kernel
               API (``kernels.ops``, as the reference's
               benchmarks/kernels_bench.py drives it), driven here once
               per checked shape with the counters zeroed before and read
               after.  The scan's ring entry is held against its plain
               version on a whole checkpoint ring (untouched slots bit for
               bit) at the falcon-mamba-7b serve's shape and on a lapping
               prefill, beside the PyTorch path it replaced (gather, scan
               with states, index_put); the plain scan's carry mode (the
               one the sequential engines launch) at their shapes; each
               verify case logs its blocks per row.
  3. tiny    — the committed Zipf-Markov pair (f32) served through
               ContinuousBatchScheduler: greedy streams must equal the
               port's own target-only greedy decode; temperature 1 (with
               the default confidence threshold, then with none, so that
               drafted chains reach the verify kernel) must launch the
               verify kernel, every verdict it gives must equal the plain
               route's on the same inputs (VerifyShadow), and its streams
               are compared with the same serve on the CPU; a small pool
               must preempt and read the swap back through the gather
               kernel.
  4. full    — the paper's LLaMA-68M / LLaMA-7B pair at full width, bf16,
               random weights from fixed seeds: 8 requests x FULL_NEW tokens
               at temperature 0 and at temperature 1 as in phase 3.  Every
               greedy token must be the argmax, within TF_MARGIN, of a
               cache-less target forward over its own request's served
               stream (teacher forcing); the temperature-1 verdicts are
               shadowed as in phase 3.  Then one profiled serve (8 new
               tokens) for the card's busy share and device time by
               kernel.
  5. seq tiny — the sequential engines (dense ring cache, flash kernel) on
               the committed pair: every engine's greedy stream must equal
               the port's own AR greedy decode; SpS and SpecBranch at
               temperature 1 are compared with the same serve on the CPU
               (printed); the flash kernel must have run.
  6. seq full — the full-width pair through the sequential engines: AR,
               SpS and SpecBranch greedy (2 requests x FULL_NEW tokens,
               teacher-forced as in phase 4) and SpecBranch at
               temperature 1 with epsilon 0; wall tokens/s and rounds per
               engine; one profiled SpecBranch serve for the busy share.
  7. hybrid tiny — the falcon-shaped (Mamba) and jamba-shaped (Mamba +
               attention + MoE) random-init pairs, f32: batched greedy
               streams must equal the port's own target-only greedy
               decode; temperature 1 (epsilon 0.3, then 0) is shadowed as
               in phase 3 and compared with the same serve on the CPU; a
               jamba-shaped serve with a small pool must preempt, swap its
               attention half through the gather kernel, restore its ring
               snapshots and give the same streams as without preemption;
               sequential SpecBranch and SpS greedy must equal AR greedy.
               The selective-scan kernel must have run.
  8. falcon  — falcon-mamba-7b (64 Mamba layers, d_model 4096) with its
               draft() at full width, bf16, random weights from fixed
               seeds: batched SpecBranch, 8 requests x 32 new tokens,
               greedy (teacher-forced as in phase 4) and temperature 1
               with epsilon 0; wall tokens/s, rounds, mean accepted length
               and launches; the ring scans' shapes (the serve must run
               phase 2's ring case shape); device memory of the weights
               and rings; one profiled serve for the busy share and
               device time by kernel, and one for the scan kernels'
               device time beside the PyTorch kernels on the h rings.
  9. H-RAD and SpS tiny — the committed pair with an H-RAD MLP from the
               port's init_mlp (generator seed HRAD_SEED): batched SpS,
               batched SpecBranch with H-RAD (also under a preempting
               200-page pool of page size 4) and sequential SpecBranch
               with H-RAD; greedy streams must equal the target's greedy
               decode; temperature 1 is shadowed as in phase 3 and
               compared with the same serve on the CPU (printed); the
               H-RAD signal histogram must hold all three classes.
 10. H-RAD and SpS full — the LLaMA-68M/7B pair again: batched SpS 8 x 16
               greedy and temperature 1, batched SpecBranch with H-RAD
               8 x 16 greedy, sequential SpecBranch with H-RAD 2 x 16
               greedy, each greedy serve teacher-forced as in phase 4;
               wall tokens/s, rounds, mean accepted length, signal
               histogram, peak memory and a profiled serve's busy share,
               beside the same serves without H-RAD from phases 4 and 6.
 11. dense   — the dense attention backend (N-row ring caches, the flash
               kernel on every attention call, branch forks as row
               copies): batched SpecBranch and SpS on the tiny committed
               pair, greedy, temperature 1 (epsilon 0.3 and 0, shadowed
               as in phase 3) and under a preempting pool that swaps; each
               drive's streams must equal the card's own paged serve
               (SpecBranch's from phase 3, whose drives are the same
               serves, held against the CPU there; phase 11's own CPU
               serves were cut to make room for phase 17); the
               jamba-shaped hybrid, whose
               preempted rows recompute their prefix; the full-width
               LLaMA-68M/7B batched SpecBranch 8 x LATE_NEW greedy,
               teacher-forced as in phase 4, what a fork's row copy costs,
               and a profiled serve's flash launches and device time
               beside phase 4's paged figures.
 12. trace   — the full-width 7B batched SpecBranch greedy serve (paged)
               untraced, then with a TraceRecorder and the loop's profiler
               ranges inside obs.profiler_session: host fetches, transfer
               bytes and streams must be equal; a table of each round's
               and each span lane's host wall time against the device-busy
               time inside it (the host's share of a round).  It runs in a
               fresh process (``--trace-modes``), whose one profiler
               session also traces the same serve in parallel draft mode
               for phase 13.
 13. parallel — single-pass parallel drafting and the history predictor.
               Tiny committed pair with draft heads from init_draft_heads
               (generator seed SV.HEADS_SEED): batched SpS and SpecBranch
               in parallel draft mode on paged and dense, greedy and at
               temperature 1 (epsilon 0.3 and 0, shadowed as in phase 3),
               one preempting pool that swaps, sequential SpS and
               SpecBranch, and the predictor on (batched, both draft
               modes, and sequential); every drive's streams must equal
               the same serve on the CPU, every greedy stream the
               target's greedy decode, and batched SpS must take exactly
               2 dispatches a round.  Full width (LLaMA-68M/7B, bf16,
               random weights and heads, 8 x LATE_NEW, paged): batched
               SpecBranch and SpS in parallel draft mode beside the same
               serves in sequential draft mode (wall tokens/s,
               dispatches per round, rounds, greedy teacher-forced as in
               phase 4), profiled serves' device time by kernel, the
               draft frames' attention launches and draft_chunk's device
               time; phase 12's host-share table for the parallel-mode
               SpecBranch serve beside the sequential-mode one; batched
               SpecBranch with the predictor on: its decided-gamma
               histogram and rollback tokens per request beside off.
 14. prefix  — the cross-request prefix cache (``prefix_cache=True``).
               Tiny committed pair, both batched engines, greedy and
               temperature 1 (shadowed as in phase 3), and the
               jamba-shaped pair greedy, on the reference test's
               staggered shared-prompt trace: every follower hits, the
               streams, prefix and pool stats must equal the same serve's
               on the CPU and the streams the cache-off serve's; the
               jamba hits restore the rings' snapshots.  Full width: the
               7B pair serving one request and then seven that share its
               512-token system prompt (32 tokens of their own) arriving
               together after it retired, cache off and on: hits (7),
               saved tokens (3584), the target's prefill forwards, staged
               tokens and device time (a profiler session around each
               prefill call of a second serve), the followers' wall TTFT
               (admission to first committed token, synchronised) and
               wall tokens/s; streams on == off.  falcon-mamba-7b serving
               one request and three that share its 256-token prompt:
               snapshot restores, each publish candidate's snapshot
               bytes and host time; streams on == off.
 15. arch    — architecture coverage.  The reduced() targets of all ten
               assigned configs (f32, random weights): the nine that
               decode with tests/test_arch_serving.py's same-family draft,
               sequential SpS and SpecBranch greedy, whose streams must
               equal the same serve on the CPU and the port's greedy
               decode; hubert's bidirectional forward over stub frames
               against the CPU's within 1e-4.  gemma3-4b at full width
               with its draft() (hd 160; window 1024, qk-norm, vocab
               262144; bf16, random weights): batched SpecBranch on the
               paged backend, 8 requests of 1000-token prompts x G3_NEW new
               tokens (past the window of 1024), greedy teacher-forced as
               in phase 4, the serve's own target logits (prefill and
               every later target forward) within TF_MARGIN of the
               cache-less forward's, and at temperature 1 (G3_T1_NEW new
               tokens) shadowed as in phase 3; the dense backend's greedy
               streams must equal the paged ones; how far two context
               faults move the logits (the comparison's yardstick);
               sequential SpecBranch 1 x 32; tokens/s, rounds, M, peak
               memory.  granite-moe-3b-a800m at full width (40 experts
               top-8 on 32 layers) with its draft() (3 heads of hd 85: the
               decode loop's ragged path): 8 requests of 256-token
               prompts x 16 new tokens, batched SpecBranch greedy on
               paged and on dense (streams equal) and sequential 1 x 16,
               teacher-forced on drop-free copies of both configs
               (capacity_factor = num_experts / top-k: a batched verify
               and the cache-less forward then route a token alike), the
               paged and flash kernels launched at hd 85 (by head dim);
               one profiled paged serve at the configs' own capacity
               1.25: the share of (token, choice) pairs dropped, and the
               draft's attention in the device time.  internvl2-2b at
               full width with its draft(): 256 stub patch embeddings
               then 32 tokens,
               sequential AR, SpS and SpecBranch, 2 x VLM_NEW greedy,
               teacher-forced over embeddings + prompt + stream.
               hubert-xlarge at full width: one cache-less bidirectional
               forward over (2, 500, 1280) frames, the flash kernel once
               per layer with causal off, its time beside phase 2's SDPA
               case.  Phase 2 holds the decode loop's draft() head dims
               144 and 160 (paged, flash, branch decode; bf16 and f32)
               and gemma3-4b's 8 x 1000 prefill rung (paged and flash,
               the target's local and global layers and the draft's);
               and the ragged path (``ragged_cases``) at
               granite-moe's draft shapes (hd 85, bf16 and f32: paged,
               flash on a ring and cache-less, branch decode, the
               backward) and hd 200, beside the same shapes at hd 64
               and 128.
 16. train   — training.  Phase 2 holds the two backward kernels (flash:
               the tiny pair's training frame, gemma3-4b's 1280-token
               frame with window 1024 and global, a softcap, hubert's
               bidirectional hd 80, the draft-head loss frame with
               invisible slot keys; the scan from the forward's chunk
               checkpoints at falcon-mamba-7b's training frame, at T =
               250, T = 20 and B = 2 of its width and a tiny f32 frame,
               two launches bit-identical, the chunk mode's hc equal to
               the states mode's hs at the boundaries)
               against their plain backwards, with SDPA's forward and
               backward as flash's library figure and SDPA's backward
               alone beside it, the bound's work over the kernel's time
               (TFLOP/s), the kernels' blocks and the largest error's
               share of its tolerance.  (a) The committed
               pair's aligned draft (400 steps), the misaligned draft's
               parallel-draft heads and its H-RAD MLP trained on the
               card into a fresh port cache; measure_alpha of both
               drafts (the aligned must beat the misaligned with greedy
               drafts); batched SpecBranch in parallel draft mode with
               the trained heads and MLP, greedy, equal to the target's
               greedy decode.  (b) The ten reduced configs: one train
               step's loss and gradients on the card equal the CPU's
               within TRAIN_RTOL / TRAIN_ATOL, every CPU-live leaf
               non-zero and finite on the card.  (c) gemma3-4b at full
               width through launch.train's path (G3_TRAIN: 2 x 1281
               tokens in 2 micro-batches, 3 steps) and (d)
               falcon-mamba-7b at full width cut to 16 layers
               (FALCON_TRAIN): finite losses, every leaf's gradient
               non-zero and finite, the backward kernels launched, step
               wall time and peak memory; gemma3-4b's second step under
               the CUDA profiler (the device's busy share of its wall
               time, the top kernels by device time, the flash
               backward's share), and falcon-mamba-7b's (the scan
               kernels' share).
 17. mesh    — mesh-sharded serving (``--mesh``, DESIGN.md §7.10): the
               ranks run as fresh processes sharing cuda:0 over gloo
               (NCCL takes no two ranks on one GPU), so the phase checks
               correctness only; its times say nothing of NVLink or of
               tensor-parallel speed.  (a) Which collectives and dtypes
               gloo takes on CUDA tensors in this PyTorch (the forward's
               all_reduce and all_gather in float32 and bfloat16, and
               broadcast, must).  (b) The tiny committed pair: at 1x1 both
               engines x both backends at temperature 1 must equal the
               card's unmeshed serve bit for bit and issue no collective;
               at 1x2 and 2x2 greedy, both engines x both backends, every
               rank's streams must equal the card's unmeshed serve and the
               target verify forward's collective census the layout's
               (``expected_forward_census``; the CPU tests pin it for the
               reference test's pair); at 1x2 also batched SpecBranch
               at temperature 1 (epsilon 0; the verify kernel per rank,
               the ranks agreeing), under a preempting pool (the gather
               kernel per rank) and the jamba-shaped pair (the ring scan
               per rank).  (c) LLaMA-68M/7B at 1x2, each rank holding
               half of every model's heads and MLP: batched SpecBranch,
               paged, MESH_FULL_ROWS x FULL_NEW greedy (4 since PR 26, 8
               before), teacher-forced against the
               single-device forward as in phase 4; each rank's peak
               memory beside phase 4's, wall tokens/s (two ranks
               time-sharing one card).  (d) Since PR 26: a tiny random
               pair with 6 query and 2 KV heads at 1x3 (SpecBranch, both
               backends, greedy): each rank holds the KV heads its query
               heads read, the middle rank pads its queries to whole
               groups; every rank's streams must equal the card's
               unmeshed serve.  (e) The FSDP x TP training mesh at 2x2:
               gemma3-4b at full width (d 2560, 8 heads / 4 KV, hd 256,
               vocabulary 262144) cut to its first 6 layers (5 local, 1
               global), 2 steps of 4 x 257 tokens in 2 micro-batches;
               every rank's losses, global gradient norms and parameter
               blocks must equal the same steps in one process on the
               card within the bf16 tolerance of MESH_TRAIN_*; each rank's peak memory beside
               the single process's, its flash forward and backward
               launches, and the census bytes of a step beside
               ``launch.steps.step_costs``' formula (which must equal the
               census).  Every rank's launches join the kernel table's; a
               failed or hung rank fails the run.
The full-width 7B pair's drives take FULL_NEW (8) new tokens a request
in phases 4, 6, 10 and 17c and LATE_NEW (8) in phases 11-14, gemma3-4b's
G3_NEW (32: its context yardstick needs rows past the window of 1024;
its temperature-1 serve G3_T1_NEW, 16), internvl2-2b's VLM_NEW (16) and
the reduced families' ARCH_N_NEW (8): each was cut (from 32, 32, 48,
32 and 12; FULL_NEW from 16 and G3_T1_NEW from G3_NEW when granite's
drive came) to make room for the later phases in the time limit on a
slow host.
Each main-path drive zeroes the kernel launch counters right before it
and reads them right after; launches made to compare a kernel with its
plain version are not counted.  The second-to-last lines are the kernel
table as one JSON object and the card's name and power limit; the last
line is the device JSON.

Exits non-zero without a result when no CUDA device is visible.

Modes that give no smoke result (exit 3): ``--kernels`` stops after
phase 2; ``--prefix`` runs phases 1-2 and 14 only; ``--arch`` phases
1-2 and 15 only; ``--train`` phases 1-2 and 16 only; ``--mesh``
phases 1-2 and 17 only; ``--attn`` times phase 2's aligned
attention cases (paged, flash, branch decode) alone: run with ``--src``
beside a run without, the aligned path's A/B; ``--probe`` times
the attention tile loops phase by phase from variants built with
-DREPRO_ATTN_STOP (1: K/V loads only, 2: loads and logits, 0: whole
kernel) beside the timing floor, and the batched
verify's rounds (-DREPRO_VERIFY_STOP) and cluster barrier cost;
``--scan`` times phase 2's plain-scan cases (states and carry modes,
the training forward's states and chunk modes, and the falcon serve's
ring entry) alone;
``--scan-bwd`` times phase 2's scan backward cases alone, the training
forward's states and chunk modes and, for this checkout's port, the
backward at falcon's frame phase by phase (-DREPRO_SCAN_BWD_STOP
variants) and at the other chunk lengths of 16, 32 and 64 steps
(-DREPRO_SCAN_CHUNK);
``--flash-bwd`` times phase 2's flash backward cases and granite's
draft frame (bf16, f32) alone, the backward's kernels at gemma3-4b's
window frame, the tiny pair's and granite's f32 frame (one profiler
session), gemma3-4b's frame phase by phase (-DREPRO_BWD_STOP variants)
and at B=2, and the f32 frames phase by phase (the same variants);
``--profile`` runs phases 4 and 6's profiled serves, the
batched LLaMA serve at temperature 1 (verify device time) and phase 8's
falcon serve (scan and h-ring device time) only.  With ``--src DIR``
(``--profile``, ``--scan``, ``--scan-bwd``, ``--flash-bwd``,
``--train``, ``--attn``) the script
imports the port from DIR (another checkout's src, e.g. the parent
commit unpacked under build/) to compare two commits in one call.
"""
from __future__ import annotations

import concurrent.futures
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
# ``--src DIR`` imports the port from another checkout's src (a parent
# commit unpacked beside this one) for ``--profile``, ``--scan``,
# ``--scan-bwd``, ``--flash-bwd``, ``--train`` or ``--attn``; default:
# this one's
SRC = (sys.argv[sys.argv.index("--src") + 1] if "--src" in sys.argv
       else os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.abspath(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core import hrad as H  # noqa: E402
from repro_torch.kernels import branch_attention as BA  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
try:                        # absent from checkouts before the decode loop
    from repro_torch.kernels import decode_attention as DA  # noqa: E402
except ImportError:
    DA = None
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged as PG  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ssm_scan as SS  # noqa: E402
from repro_torch.kernels import verify_accept as VA  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import engines as TE  # noqa: E402
from repro_torch.runtime import runner as RN  # noqa: E402
from repro_torch.runtime.engines import EngineConfig  # noqa: E402
from repro_torch.serving import batched_engine as BE  # noqa: E402
from repro_torch.serving import device_loop as DL  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
# Largest gap (in logits) allowed between a served greedy token's logit and
# the top logit of the cache-less teacher-forced target forward, bf16.  The
# random 7B's logits are ~N(0, 1) over 32000 ids (top ~4.2, bf16 spacing
# 1/32 there), and two bf16 forwards that differ only in shapes and
# reduction order disagree by ~0.1 on an H100 (printed as the noise
# yardstick); a token served from a wrong context sits ~1-4 below the top.
TF_MARGIN = 0.25
# A uniform within this distance of a boundary (an accept ratio or a cdf
# entry) may go either way between two float summation orders.
BOUNDARY_EPS = 1e-6
EPS = EngineConfig.epsilon      # the engines' default confidence threshold
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # CUDA f32 / bf16
# f32 work on the tensor cores as 3xTF32 (three TF32 products at 495
# TFLOP/s each): the rate the f32 flash backward's design can reach
PEAK_3XTF32 = 495e12 / 3

KERNELS = {
    "paged_attention": dict(
        route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:161"),
    "verify_accept_batched": dict(
        route="cuda", source="src/repro_torch/csrc/verify_accept.cu",
        replaces="src/repro/kernels/verify_accept.py:144"),
    "paged_gather": dict(
        route="cuda", source="src/repro_torch/csrc/paged_gather.cu",
        replaces="src/repro/kernels/paged.py:42"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:102"),
    "ssm_scan": dict(
        route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:80"),
    # the same TPU kernel with the serving layer's checkpoint-ring gather
    # and scatter around it, addressed in place (second entry point)
    "ssm_scan_ring": dict(
        route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:80"),
    "branch_decode_attention": dict(
        route="cuda", source="src/repro_torch/csrc/branch_attention.cu",
        replaces="src/repro/kernels/ops.py:38"),
    "verify_accept": dict(
        route="cuda", source="src/repro_torch/csrc/verify_accept.cu",
        replaces="src/repro/kernels/verify_accept.py:74"),
    # the backwards of the two kernels under the training forward (the
    # TPU kernels have none: the reference differentiates their jnp twins)
    "flash_attention_bwd": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:102"),
    "ssm_scan_bwd": dict(
        route="cuda", source="src/repro_torch/csrc/ssm_scan_bwd.cu",
        replaces="src/repro/kernels/ssm_scan.py:80"),
}
# the H-RAD MLP of phases 9-10: the port's init_mlp under this generator
# seed (untrained; on the tiny pair it gives all three signal classes)
HRAD_SEED = 0
# the selective scan against its plain version: the tolerance the
# reference's own tests hold its Pallas kernel to (both sides f32; only
# exp's rounding and the FMA contraction differ)
SSM_RTOL = SSM_ATOL = 2e-5
# the falcon-mamba-7b serve's checkpoint ring depth (gamma 4, the
# engines' default branch gamma, phase 8's config), and its phase-2 case
FALCON_RING = 92
FALCON_RING_CASE = "falcon-7b serve B=8 T=16 Rg=92"
# the swap readback at the LLaMA-7B target's full width (swap_dim 262144
# f32 per token: K and V of 32 layers x 32 heads x 128), 60 rows of 4 pages
GATHER_FULL_CASE = "llama-7b swap 4x16 dim=262144 60 rows"
# the prefix cache's 7B suffix prefill frame (phase 14's followers)
PC_ATTN_CASE = "llama-7b suffix B=8 T=32 q0=512"
# phase 15: the reduced families' new tokens (tests/test_arch_serving.py),
# gemma3-4b's prompts and new tokens (the last positions past the local
# window of 1024), internvl2-2b's stub patches and prompt, hubert's frames
ARCH_N_NEW = 8
G3_PROMPT, G3_NEW = 1000, 32
# gemma3-4b's temperature-1 serve: the verify shadow at V = 262144 needs
# no row past the window (the greedy serves reach them)
G3_T1_NEW = 16
# granite-moe-3b-a800m's prompts and new tokens (its draft's hd 85: the
# decode loop's ragged path)
GRANITE_PROMPT, GRANITE_NEW = 256, 16
VLM_PATCHES, VLM_PROMPT, VLM_NEW = 256, 32, 16
HUBERT_FRAMES = (2, 500)
HUBERT_CASE = "hubert-xl hd80 B=2 T=S=500 bidir"
# new tokens a request of the full-width 7B drives of phases 4, 6, 10 and
# 17c (FULL_NEW) and of phases 11-14 (LATE_NEW), both cut from 32 (FULL_NEW
# to 16, then to 8 when phase 15's granite drive came) so that the later
# phases fit the script's time limit on a slow host
FULL_NEW = 8
LATE_NEW = 8
# phase 16: the backward kernels' representative phase-2 cases (gemma3-4b's
# local layers at the training frame of phase 16c, falcon-mamba-7b's
# width), the gemma3-4b and falcon-mamba-7b training drives (batch x seq
# tokens, micro-batches, steps; falcon's depth cut to fit four bf16
# copies of its weights), and the reduced card-vs-CPU gradient tolerance
# (kernels' and PyTorch's f32 summation orders through a forward and
# backward)
FLASH_BWD_CASE = "gemma3-4b train B=1 T=S=1280 w1024"
TINY_BWD_CASE = "zm-target train B=16 T=S=63"
GRANITE_BWD_CASE = "granite draft hd85 {} train B=1 T=S=256"
# the frames ``--flash-bwd`` splits by kernel: gemma3-4b's (bf16), the
# tiny pair's and granite's draft's (f32)
BWD_SPLIT_FRAMES = (FLASH_BWD_CASE, TINY_BWD_CASE,
                    GRANITE_BWD_CASE.format("f32"))
SCAN_BWD_CASE = "falcon-7b train B=1 T=256 E=8192"
G3_TRAIN = dict(batch=2, seq=1281, micro=2, steps=3)
FALCON_TRAIN = dict(batch=2, seq=257, micro=2, steps=2, layers=16)
TRAIN_RTOL, TRAIN_ATOL = 1e-3, 1e-4
# phase 17: new tokens a request of the mesh's tiny drives, and each
# spawn's own time limit (a hung rank fails the run there)
MESH_TINY_NEW = 12          # 16 before PR 26's phase 17d/e
MESH_JOIN_S = 420.0
MESH_FULL_PAIR = "paper-llama"      # phase 17c's pair (LLaMA-68M/7B)
MESH_FULL_ROWS = 4          # its requests (8 before PR 26's phase 17e)
MESH_PREEMPT_POOL = 60      # SpS, 4 x 12 tokens, pages of 4: preempts
# phase 17 (since PR 26): the 1x3 drive's pair (6 query / 2 KV heads, hd
# 16: each rank holds the KV heads its query heads read, the middle
# rank's queries padded to whole groups) and the 2x2 FSDP x TP training
# drive: gemma3-4b at full width cut to its first 6 layers (5 local + 1
# global), 2 steps of 4 x 257 tokens in 2 micro-batches, held against the
# same steps in one process on the card in bf16: losses within
# MESH_TRAIN_LOSS_ATOL, each step's global gradient norm within
# MESH_TRAIN_GNORM_RTOL (AdamW's update hides a gradient's scale, the
# norm does not), each leaf's update (after less before) at a cosine of
# at least MESH_TRAIN_COS with the single process's (bf16 gradients
# summed in other orders: the embedding's, the lowest, read 0.991-0.992
# on the card in PR 26's call 2; a wrong gradient reads near 0), and
# every parameter
# within 2.1 x the steps' summed learning rates (AdamW moves a weight by
# at most about lr a step) plus MESH_TRAIN_ULPS bf16 spacings (2^-7
# relative) of its leaf's largest magnitude
MESH_TRAIN = dict(layers=6, batch=4, seq=257, micro=2, steps=2)
MESH_TRAIN_LOSS_ATOL = 0.02
MESH_TRAIN_GNORM_RTOL = 0.02
MESH_TRAIN_COS = 0.95
MESH_TRAIN_ULPS = 2


def log(*a) -> None:
    print(*a, flush=True)


T0 = time.time()


def log_phase(msg: str) -> None:
    """A phase's header line, with the seconds since the script started."""
    log(f"{msg} (t={time.time() - T0:.0f}s)")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


_FLUSH = None
# time_ms: calls slower than this (s, host clock, warm) are timed fewer
# times -- the plain scans' Python loops, 9-98 ms a call, took ~8 s of
# phase 2 at 21 iterations
SLOW_CALL_S, SLOW_ITERS = 0.005, 5


def time_ms(fn, iters: int = 21, warmup: int = 3,
            flush: str = "dirty") -> float:
    """Median device time of one call, from CUDA events recorded right
    before and after it; a call whose warm-up takes over SLOW_CALL_S each
    (a plain version's Python loop) is timed SLOW_ITERS times.  A spin kernel holds the card while the host
    enqueues every call, so the calls then run back to back and the events
    time device work, not host launch overhead.  The 50 MB L2 is flushed
    (a bitwise_not pass over 64 MB, outside the events) before every call,
    as the main path finds its inputs cold; that pass leaves L2 full of
    dirty lines.  ``flush="clean"`` flushes with a read-only pass (a max
    over the 64 MB) instead and ``"none"`` not at all (``--probe`` reads
    the harness's own share from the three)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if (time.time() - t0) / warmup > SLOW_CALL_S:
        iters = min(iters, SLOW_ITERS)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)          # ~50 ms of device spin
    for a, b in ev:
        if flush == "dirty":
            _FLUSH.bitwise_not_()
        elif flush == "clean":
            _FLUSH.max()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def check_close(name, got, want) -> tuple:
    """Hold an attention kernel's output against its plain version; returns
    (max abs error, its largest share of the elementwise bound).  f32:
    1e-4 absolute.  bf16: min(2e-2, 1.6e-2 * |want| + 1e-3 * rms(want))
    per element -- two bf16 spacings of the value (both sides round an f32
    result that differs only in summation order), never above 2e-2."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        lim = torch.full_like(err, 1e-4)
    else:
        w = want.float()
        rms = w.pow(2).mean().sqrt()
        lim = (1.6e-2 * w.abs() + 1e-3 * rms).clamp_max(2e-2)
    share = (err / lim).max().item()
    if not math.isfinite(share) or share > 1.0:
        raise AssertionError(f"{name}: max err {err.max().item():.3e} is "
                             f"{share:.2f}x its bound")
    return err.max().item(), share


def bound(nbytes: float, ops_: float, dtype, peak: float = 0.0) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops_ / (peak or PEAK_OPS[dtype]) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def attn_case(rng, B, T, H, KV, hd, ps, dtype, n_idle=0, max_len=112,
              min_len=17, n_max=None, nreal=None, prefix=None):
    """Fragmented page tables over random ragged rows; ``n_idle`` rows are
    unbound (lens 0), as most draft rows are on the main path.  ``n_max``
    widens the tables (trash-padded) to a serve's width, which covers its
    longest request, not the rows at hand.  ``nreal`` (B,) makes a
    parallel-draft frame: row b's queries start at lens - nreal[b], so
    its last T - nreal[b] queries (the draft slots) lie at or past
    lens.  ``prefix = (q_start, suffix)`` makes a prefix-cache suffix
    prefill: every live row's queries start at q_start, its lens is
    q_start + suffix (the rung's last T - suffix queries are pad), and
    the rows' tables share their first q_start / ps pages (the cached
    run) before their own; idle rows are the frame's pad lanes (lens 0,
    queries from 0)."""
    if prefix is not None:
        q0, sfx = prefix
        assert q0 % ps == 0 and 1 <= sfx <= T
        lens = [q0 + sfx] * (B - n_idle) + [0] * n_idle
        shared = q0 // ps
        n_pages = [-(-ln // ps) - shared if ln else 0 for ln in lens]
        P = shared + sum(n_pages)
        perm = rng.permutation(P)
        n_max = max(shared + max(n_pages), n_max or 0)
        table = np.full((B, n_max), P, np.int32)
        off = shared
        for b, n in enumerate(n_pages):
            if lens[b]:
                table[b, :shared] = perm[:shared]
                table[b, shared:shared + n] = perm[off:off + n]
                off += n
    else:
        lens = [int(rng.integers(max(T, min_len), max_len + 1))
                for _ in range(B)]
        for b in range(B - n_idle, B):
            lens[b] = 0
        n_pages = [-(-ln // ps) for ln in lens]
        P = sum(n_pages)
        n_max = max(max(n_pages), 1, n_max or 0)
        table = np.full((B, n_max), P, np.int32)
        perm = rng.permutation(P)
        off = 0
        for b, n in enumerate(n_pages):
            table[b, :n] = perm[off:off + n]
            off += n
    dev = "cuda"
    kp = torch.from_numpy(rng.standard_normal((P + 1, ps, KV, hd),
                                              np.float32)).to(dev, dtype)
    vp = torch.from_numpy(rng.standard_normal((P + 1, ps, KV, hd),
                                              np.float32)).to(dev, dtype)
    q = torch.from_numpy(rng.standard_normal((B, T, H, hd),
                                             np.float32)).to(dev, dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    if prefix is not None:
        qs = torch.tensor([prefix[0] if ln else 0 for ln in lens],
                          dtype=torch.int32, device=dev)
        return q, kp, vp, torch.from_numpy(table).to(dev), lens_t, qs
    back = T if nreal is None else torch.tensor(nreal, dtype=torch.int32,
                                                device=dev)
    qs = torch.clamp(lens_t - back, min=0).to(torch.int32)
    return q, kp, vp, torch.from_numpy(table).to(dev), lens_t, qs


def check_attention(rng, label, B, T, H, KV, hd, ps, dtype, n_idle=0,
                    window=0, **lens_kw):
    """The paged kernel against its plain version on ``attn_case``'s
    tables (its keyword arguments in ``lens_kw``)."""
    q, kp, vp, table, lens, qs = attn_case(rng, B, T, H, KV, hd, ps, dtype,
                                           n_idle, **lens_kw)
    kw = dict(window=window)
    out = PA.paged_attention(q, kp, vp, table, lens, qs, **kw)
    want = ref.paged_attention_ref(q, kp, vp, table, lens, qs, **kw)
    torch.cuda.synchronize()
    err, share = check_close(f"paged_attention {label}", out, want)
    es = kp.element_size()
    ps_ = kp.shape[1]
    S = table.shape[1] * ps_
    kpos = torch.arange(S, device="cuda")
    qpos = qs.long()[:, None] + torch.arange(T, device="cuda")[None]
    vis = ((kpos[None, None] < lens.long()[:, None, None])
           & (kpos[None, None] <= qpos[:, :, None]))
    if "prefix" in lens_kw:
        # shared pages are read once: the distinct pages of the rows'
        # live spans, and the products each query computes
        live = {int(table[b, i]) for b in range(B)
                for i in range(-(-int(lens[b]) // ps_))}
        nbytes = (2 * len(live) * ps_ * KV * hd * es + 2 * q.numel() * es
                  + (table.numel() + 2 * B) * 4)
        flops = 4 * H * hd * int(vis.sum())
    elif window > 0 or "nreal" in lens_kw:
        # the work a window or a frame leaves: the keys some query sees,
        # read once, and the products the queries compute
        if window > 0:
            vis &= (qpos[:, :, None] - kpos[None, None]) < window
        nbytes = (2 * int(vis.any(1).sum()) * KV * hd * es
                  + 2 * q.numel() * es + (table.numel() + 2 * B) * 4)
        flops = 4 * H * hd * int(vis.sum())
    else:
        pages = int(sum(-(-int(n) // ps_) for n in lens.tolist()))
        nbytes = (2 * pages * ps_ * KV * hd * es + 2 * q.numel() * es
                  + (table.numel() + 2 * B) * 4)
        flops = 4 * H * hd * int(vis.sum())
    bms, by = bound(nbytes, flops, dtype)
    ms = time_ms(lambda: PA.paged_attention(q, kp, vp, table, lens, qs,
                                            **kw))
    plain = time_ms(lambda: ref.paged_attention_ref(q, kp, vp, table, lens,
                                                    qs, **kw))
    # library yardstick: SDPA over the pre-gathered dense KV (timed only)
    kd = kp[table.long()].reshape(B, S, KV, hd).transpose(1, 2)
    vd = vp[table.long()].reshape(B, S, KV, hd).transpose(1, 2)
    kd = kd.repeat_interleave(H // KV, dim=1).contiguous()
    vd = vd.repeat_interleave(H // KV, dim=1).contiguous()
    mask = vis[:, None]
    qd = q.transpose(1, 2).contiguous()
    lib = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         attn_mask=mask))
    splits = PA.split_plan(B, T, H, KV, table.shape[1], ps_,
                           DA.sm_count(q.device))[0]
    return dict(case=label, max_abs_err=err, err_share=share, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                splits=splits)


def cdf_distance(p_lg, q_lg, tok_a, tok_b, w) -> float:
    """Distance, in f64, from the residual uniform w to the nearest cdf
    entry between two residual tokens of one draft position (p_lg, q_lg
    its (V,) logits): where it is below BOUNDARY_EPS the two draws differ
    only by float summation order."""
    p = torch.softmax(p_lg.double(), -1)
    qq = torch.softmax(q_lg.double(), -1)
    rr = (p - qq).clamp_min(0)
    rr = rr / rr.sum() if rr.sum() > 1e-12 else p
    cdf = torch.cumsum(rr, 0)
    cdf = (cdf / cdf[-1]).cpu()
    lo, hi = sorted((int(tok_a), int(tok_b)))
    return float((cdf[max(lo - 1, 0):hi] - float(w)).abs().min())


def check_verify(rng, label, B, R, V, lens_to=None):
    """The batched verify against its plain version; ``lens_to`` replaces
    the drawn lens after the draw (so later draws stay as they were)."""
    dev = "cuda"
    pl = torch.from_numpy(3 * rng.standard_normal((B, R, V), np.float32)
                          ).to(dev)
    ql = torch.from_numpy(3 * rng.standard_normal((B, R, V), np.float32)
                          ).to(dev)
    tok = torch.from_numpy(rng.integers(0, V, (B, R)).astype(np.int32)
                           ).to(dev)
    lens = torch.from_numpy(rng.integers(0, R + 1, B).astype(np.int32)
                            ).to(dev)
    u = torch.from_numpy(rng.random((B, R), np.float32)).to(dev)
    w = torch.from_numpy(rng.random((B, R), np.float32)).to(dev)
    if lens_to is not None:
        lens = torch.full((B,), lens_to, dtype=torch.int32, device=dev)
    got = VA.verify_accept_batched(pl, ql, tok, lens, u, w)
    want = ref.verify_accept_batched_ref(pl, ql, tok, lens, u, w)
    torch.cuda.synchronize()
    acc, res, pt, qt = (x.cpu() for x in got)
    acc_w, res_w, pt_w, qt_w = (x.cpu() for x in want)
    if not torch.equal(acc, acc_w):
        raise AssertionError(f"verify {label}: accept flags differ")
    for name, a, b in (("p_tok", pt, pt_w), ("q_tok", qt, qt_w)):
        if not torch.allclose(a, b, rtol=1e-5, atol=0.0):
            raise AssertionError(f"verify {label}: {name} differs beyond "
                                 "rtol 1e-5")
    # residual tokens may differ only where w lies within 1e-6 of a cdf
    # boundary of the plain version
    boundary = 0
    for b, r in zip(*torch.nonzero(res != res_w, as_tuple=True)):
        b, r = int(b), int(r)
        if cdf_distance(pl[b, r], ql[b, r], res[b, r], res_w[b, r],
                        w[b, r]) > BOUNDARY_EPS:
            raise AssertionError(f"verify {label}: residual token differs "
                                 f"at ({b},{r}) away from a cdf boundary")
        boundary += 1
    valid = int(lens.sum())
    nbytes = 2 * valid * V * 4 + B * R * (4 * 4 + 4 * 4) + B * 4
    bms, by = bound(nbytes, 8 * valid * V, torch.float32)
    ms = time_ms(lambda: VA.verify_accept_batched(pl, ql, tok, lens, u, w))
    plain = time_ms(lambda: ref.verify_accept_batched_ref(pl, ql, tok, lens,
                                                          u, w))
    err = max((pt - pt_w).abs().max().item(), (qt - qt_w).abs().max().item())
    n = VA.split_plan(V, B * R, DA.sm_count(pl.device))
    return dict(case=label, max_abs_err=err, boundary_cases=boundary,
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms,
                bound_by=by, splits=n, live_rows=valid)


def check_gather(rng, label, P, ps, dim, n, valid):
    pages = torch.from_numpy(rng.standard_normal((P, ps, dim), np.float32)
                             ).cuda()
    table = torch.from_numpy(rng.permutation(P)[:n].astype(np.int32)).cuda()
    out = PG.paged_gather(pages, table, valid)
    want = ref.paged_gather_ref(pages, table, valid)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError(f"paged_gather {label}: not bitwise equal")
    nbytes = valid * dim * 4 + n * ps * dim * 4 + n * 4
    bms, by = bound(nbytes, 0, torch.float32)
    ms = time_ms(lambda: PG.paged_gather(pages, table, valid))
    plain = time_ms(lambda: ref.paged_gather_ref(pages, table, valid))
    # yardstick: index_select moves the same pages (without the tail zeros)
    lib = time_ms(lambda: torch.index_select(pages, 0, table))
    return dict(case=label, max_abs_err=0.0, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by)


def flash_case(rng, B, T, S, H, KV, hd, L, dtype, stale=0):
    """A dense ring of S slots after L tokens, as the runner leaves it:
    slot s holds the newest position p < L with p % S == s (the ring
    wraps when L > S) or -1; ``stale`` slots hold positions past L (a
    rollback's leftovers).  The T queries sit at L - T .. L - 1."""
    kpos = np.full((B, S), -1, np.int32)
    for b in range(B):
        for p in range(max(0, L - S), L):
            kpos[b, p % S] = p
        own = {p % S for p in range(L - T, L)}
        free = [s for s in range(S) if s not in own]
        kpos[b, rng.permutation(np.asarray(free, np.int64))[:stale]] = L + 2
    qpos = np.ascontiguousarray(np.broadcast_to(
        np.arange(L - T, L, dtype=np.int32), (B, T)))
    dev = "cuda"
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)
                             ).to(dev, dtype)
            for shape in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd))] + [
        torch.from_numpy(qpos).to(dev), torch.from_numpy(kpos).to(dev)]


def check_flash(rng, label, B, T, S, H, KV, hd, L, dtype, stale=0,
                window=0, cap=None, causal=True):
    q, k, v, qp, kp = flash_case(rng, B, T, S, H, KV, hd, L, dtype, stale)
    kw = dict(window=window, cap=cap, causal=causal)
    out = FA.flash_attention(q, k, v, qp, kp, **kw)
    want = ref.flash_attention_ref(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    err, share = check_close(f"flash_attention {label}", out, want)
    # the work these positions need: per query the keys it sees; per
    # (row, kv head) the K/V of keys some query of the row sees
    kpl, qpl = kp.long()[:, None, :], qp.long()[:, :, None]
    vis = (kpl >= 0) & ((kpl <= qpl) if causal else True)
    if window > 0:
        vis &= (qpl - kpl) < window
    G = H // KV
    es = q.element_size()
    keys_row = int(vis.any(1).sum())
    nbytes = (2 * keys_row * KV * hd * es + 2 * q.numel() * es
              + (kp.numel() + qp.numel()) * 4)
    flops = 4 * hd * int(vis.sum()) * KV * G
    bms, by = bound(nbytes, flops, dtype)
    ms = time_ms(lambda: FA.flash_attention(q, k, v, qp, kp, **kw))
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, qp, kp, **kw))
    lib = None
    if cap is None:
        # library yardstick: SDPA with a boolean mask over the same dense
        # KV, heads expanded for the group (timed only)
        kd = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vd = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        qd = q.transpose(1, 2).contiguous()
        mask = vis[:, None]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
    splits = FA.split_plan(B, T, H, KV, S, DA.sm_count(q.device))[0]
    return dict(case=label, max_abs_err=err, err_share=share, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                splits=splits)


def check_flash_frame(rng, label, B, T, S, H, KV, hd, L, dtype, nreal):
    """Flash at a parallel-draft frame of the dense backend: after L
    committed tokens, row b's T queries sit at L .. L + T - 1, the first
    nreal[b] real and the rest draft slots, whose keys were written to
    their ring slots at position -1 and whose queries see up to the last
    real position (q_ctx < q_pos)."""
    kpos = np.full((B, S), -1, np.int32)
    qctx = np.zeros((B, T), np.int32)
    for b in range(B):
        for p in range(max(0, L + T - S), L + nreal[b]):
            kpos[b, p % S] = p
        qctx[b] = np.minimum(L + np.arange(T), L + nreal[b] - 1)
    qpos = np.ascontiguousarray(np.broadcast_to(
        np.arange(L, L + T, dtype=np.int32), (B, T)))
    dev = "cuda"
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(dev, dtype)
               for shape in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    qp, kp, qc = (torch.from_numpy(x).to(dev) for x in (qpos, kpos, qctx))
    out = FA.flash_attention(q, k, v, qp, kp, q_ctx=qc)
    want = ref.flash_attention_ref(q, k, v, qp, kp, q_ctx=qc)
    torch.cuda.synchronize()
    err, share = check_close(f"flash_attention {label}", out, want)
    kpl, qcl = kp.long()[:, None, :], qc.long()[:, :, None]
    vis = (kpl >= 0) & (kpl <= qcl)
    G = H // KV
    es = q.element_size()
    nbytes = (2 * int(vis.any(1).sum()) * KV * hd * es + 2 * q.numel() * es
              + (kp.numel() + 2 * qp.numel()) * 4)
    bms, by = bound(nbytes, 4 * hd * int(vis.sum()) * KV * G, dtype)
    ms = time_ms(lambda: FA.flash_attention(q, k, v, qp, kp, q_ctx=qc))
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, qp, kp,
                                                    q_ctx=qc))
    kd = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vd = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    qd = q.transpose(1, 2).contiguous()
    mask = vis[:, None]
    lib = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         attn_mask=mask))
    splits = FA.split_plan(B, T, H, KV, S, DA.sm_count(q.device))[0]
    return dict(case=label, max_abs_err=err, err_share=share, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                splits=splits)


def check_ssm(rng, label, B, T, E, N, xdtype, states, chunks=False):
    """The selective-scan kernel against ``ssm_scan_ref`` on inputs shaped
    like a Mamba layer's: dt = softplus(normal), A = -exp(0.2 normal);
    ``chunks``: the chunk mode (hc at the library's K in place of hs)."""
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).cuda()
    x = f(B, T, E).to(xdtype)
    dt = F.softplus(f(B, T, E))
    Bm, Cm, h0 = f(B, T, N), f(B, T, N), f(B, E, N)
    A = -torch.exp(f(E, N) * 0.2)
    D = torch.ones(E, device="cuda")
    args = (x, dt, Bm, Cm, A, D, h0)
    kw = dict(chunks=True) if chunks else dict(return_states=states)
    refkw = dict(chunk=SS.scan_chunk()) if chunks else kw
    got = SS.ssm_scan(*args, **kw)
    want = ref.ssm_scan_ref(*args, **refkw)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("y", "hT", "hc" if chunks else "hs"), got, want):
        d = (g - w).abs()
        if not bool((d <= SSM_ATOL + SSM_RTOL * w.abs()).all()):
            raise AssertionError(f"ssm_scan {label}: {name} differs beyond "
                                 f"rtol=atol={SSM_RTOL} (max "
                                 f"{d.max().item():.3e})")
        err = max(err, d.max().item())
    nbytes = (x.numel() * x.element_size() + (dt.numel() + Bm.numel()
              + Cm.numel() + A.numel() + D.numel() + h0.numel()) * 4
              + sum(g.numel() for g in got) * 4)
    bms, by = bound(nbytes, 7 * B * T * E * N, torch.float32)
    ms = time_ms(lambda: SS.ssm_scan(*args, **kw))
    plain = time_ms(lambda: ref.ssm_scan_ref(*args, **refkw))
    # no single PyTorch call computes a selective scan: library_ms null
    return dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=None, bound_ms=bms, bound_by=by)


# the carry mode (no states) at the sequential engines' shapes, the only
# mode an engine launches through ``ssm_scan``: phase 7's most frequent
# (SpecBranch's branch tick over 4 branches of the tiny pairs' draft, and
# their target's verify chunk of gamma + 1 = 5), and that chunk at
# falcon-mamba-7b's width
SEQ_CARRY_CASE = "seq branch tick B=4 T=1 E=64 f32"


def carry_cases(rng) -> list:
    f32, bf16 = torch.float32, torch.bfloat16
    return [check_ssm(rng, SEQ_CARRY_CASE, 4, 1, 64, 16, f32, False),
            check_ssm(rng, "seq verify B=1 T=5 E=128 f32", 1, 5, 128, 16,
                      f32, False),
            check_ssm(rng, "falcon-7b seq verify B=1 T=5", 1, 5, 8192, 16,
                      bf16, False)]


def train_fwd_chunks(rng) -> dict:
    """The chunk mode at falcon-mamba-7b's training frame, as
    ``SsmScanFn`` launches it on the main path (phase 16)."""
    return check_ssm(rng, "falcon-7b train fwd chunks", 1, 256, 8192, 16,
                     torch.bfloat16, False, chunks=True)


def train_fwd_cases(rng) -> list:
    """The training forward at falcon-mamba-7b's frame: the states mode
    (what ``SsmScanFn`` launched before chunk checkpoints) and, where the
    port has it, the chunk mode it launches now."""
    rows = [check_ssm(rng, "falcon-7b train fwd states", 1, 256, 8192, 16,
                      torch.bfloat16, True)]
    if hasattr(SS, "scan_chunk"):
        rows.append(train_fwd_chunks(rng))
    return rows


def phase_scan() -> None:
    """``--scan``: phase 2's plain-scan cases, every mode, alone (with
    ``--src``, of another checkout's kernel): states, carry, the training
    forward's states and chunk modes, and the falcon serve's ring
    entry."""
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    rows = [check_ssm(rng, "falcon-7b decode B=8 T=8", 8, 8, 8192, 16, bf16,
                      True),
            check_ssm(rng, "falcon-7b cache-less B=8 T=48", 8, 48, 8192, 16,
                      bf16, False)] + carry_cases(rng) + train_fwd_cases(rng)
    rows += falcon_ring_cases(rng)
    timing_floor()
    for r in rows:
        log(f"  {r['case']:32s} err={r['max_abs_err']:.2e} "
            f"ms={r['ms']:.4f} bound={r['bound_ms']:.4f} "
            f"plain={r['plain_ms']:.4f}")


def falcon_ring_cases(rng) -> list:
    """The ring entry at the falcon-mamba-7b serve's two target shapes (8
    lanes of T = 16, its most frequent, and of T = 8, over 8 ring rows of
    depth FALCON_RING; two fresh lanes, two wrapping past slot Rg - 1,
    one pad lane)."""
    lanes = dict(p0=[0, 37, FALCON_RING - 2, 0, 12, 55, 90, 3],
                 rows=[5, 0, 7, 2, -1, 1, 6, 3])
    return [check_ssm_ring(rng, FALCON_RING_CASE, 8, 16, 8192, 16,
                           FALCON_RING, 8, torch.bfloat16, **lanes),
            check_ssm_ring(rng, "falcon-7b serve B=8 T=8 Rg=92", 8, 8, 8192,
                           16, FALCON_RING, 8, torch.bfloat16, **lanes)]


def ring_written(B, T, Rg, n_rows, p0, rows) -> torch.Tensor:
    """(n_rows, Rg) mask of the ring slots a ring scan writes: the
    trailing min(T, Rg) steps of every live lane."""
    w = torch.zeros((n_rows, Rg), dtype=torch.bool)
    for b in range(B):
        if rows[b] >= 0:
            for t in range(T - min(T, Rg), T):
                w[rows[b], (p0[b] + t + 1) % Rg] = True
    return w


def check_ssm_ring(rng, label, B, T, E, N, Rg, n_rows, xdtype, p0, rows):
    """The ring entry against ``ssm_scan_ring_ref`` on one whole ring
    h_ring (n_rows, Rg, E, N): slots no lane writes bit for bit
    untouched, y and the written slots within SSM_RTOL / SSM_ATOL.  p0
    start positions (0: a fresh lane), rows the lane map (-1: a pad
    lane).  Also times the PyTorch path this entry replaces: the gather
    of h0, the scan kernel with every post-step state and the index_put
    of the trailing states (``glue_ms``)."""
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).cuda()
    x = f(B, T, E).to(xdtype)
    dt = F.softplus(f(B, T, E))
    Bm, Cm = f(B, T, N), f(B, T, N)
    A = -torch.exp(f(E, N) * 0.2)
    D = torch.ones(E, device="cuda")
    ring = f(n_rows, Rg, E, N)
    args = (x, dt, Bm, Cm, A, D)
    p0_t = torch.tensor(p0, dtype=torch.int32, device="cuda")
    rows_t = torch.tensor(rows, dtype=torch.int32, device="cuda")
    got_ring, want_ring = ring.clone(), ring.clone()
    y = SS.ssm_scan_ring(*args, got_ring, p0_t, rows_t)
    yw = ref.ssm_scan_ring_ref(*args, want_ring, p0_t, rows_t)
    torch.cuda.synchronize()
    wr = ring_written(B, T, Rg, n_rows, p0, rows).cuda()
    if not torch.equal(got_ring[~wr], ring[~wr]):
        raise AssertionError(f"ssm_scan_ring {label}: a slot no lane "
                             "writes changed")
    err = 0.0
    for name, g, w in (("y", y, yw), ("ring", got_ring[wr], want_ring[wr])):
        d = (g - w).abs()
        if not bool((d <= SSM_ATOL + SSM_RTOL * w.abs()).all()):
            raise AssertionError(f"ssm_scan_ring {label}: {name} differs "
                                 f"beyond rtol=atol={SSM_RTOL} (max "
                                 f"{d.max().item():.3e})")
        err = max(err, d.max().item())
    live = [b for b in range(B) if rows[b] >= 0]
    loads = sum(1 for b in live if p0[b] != 0)
    nbytes = (x.numel() * x.element_size()
              + (dt.numel() + Bm.numel() + Cm.numel() + A.numel()
                 + D.numel() + y.numel()) * 4 + 2 * B * 4
              + (loads + len(live) * min(T, Rg)) * E * N * 4)
    bms, by = bound(nbytes, 7 * B * T * E * N, torch.float32)
    ms = time_ms(lambda: SS.ssm_scan_ring(*args, got_ring, p0_t, rows_t))
    plain = time_ms(lambda: ref.ssm_scan_ring_ref(*args, want_ring, p0_t,
                                                  rows_t))
    rl = rows_t.long()
    live_t = rl >= 0
    fresh = ((p0_t == 0) | ~live_t)[:, None, None]
    Tr = min(T, Rg)
    slots = (p0_t.long()[:, None]
             + torch.arange(T - Tr, T, device="cuda")[None] + 1) % Rg
    lidx = live_t.nonzero()[:, 0]
    lrows, lslots = rl[lidx], slots[lidx]

    def glue():     # the layer's ring path before the ring entry
        h0 = torch.where(fresh, 0.0, want_ring[rl.clamp_min(0),
                                               p0_t.long() % Rg])
        out = SS.ssm_scan(*args, h0.contiguous(), return_states=True)
        want_ring[lrows[:, None], lslots] = out[2][lidx, T - Tr:]
    glue_ms = time_ms(glue)
    # no single PyTorch call computes a selective scan: library_ms null
    return dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=None, bound_ms=bms, bound_by=by, glue_ms=glue_ms)


def branch_case(rng, kb, Tq, Sp, Ss, Hh, KV, hd, dtype, dead=0):
    """k branches over one shared prefix of Sp keys (``dead`` of them
    unwritten, position -1) and Ss suffix keys each; the Tq queries of
    each branch sit at the last positions, so Tq > 1 cuts the suffix
    causally."""
    dev = "cuda"
    ppos = np.arange(Sp, dtype=np.int32)[None].copy()
    ppos[0, 1:1 + dead] = -1
    spos = np.ascontiguousarray(np.broadcast_to(
        np.arange(Sp, Sp + Ss, dtype=np.int32), (kb, Ss)))
    qpos = np.ascontiguousarray(np.broadcast_to(
        np.arange(Sp + Ss - Tq + 1, Sp + Ss + 1, dtype=np.int32), (kb, Tq)))
    q, pk, pv, sk, sv = (
        torch.from_numpy(rng.standard_normal(shape, np.float32)
                         ).to(dev, dtype)
        for shape in ((kb, Tq, Hh, hd), (1, Sp, KV, hd), (1, Sp, KV, hd),
                      (kb, Ss, KV, hd), (kb, Ss, KV, hd)))
    return (q, pk, pv, torch.from_numpy(ppos).to(dev), sk, sv,
            torch.from_numpy(spos).to(dev), torch.from_numpy(qpos).to(dev))


def check_branch(rng, label, kb, Tq, Sp, Ss, Hh, KV, hd, dtype, dead=0,
                 cap=None):
    args = branch_case(rng, kb, Tq, Sp, Ss, Hh, KV, hd, dtype, dead)
    q, pk, pv, ppos, sk, sv, spos, qpos = args
    out = BA.branch_decode_attention(*args, cap=cap)
    want = ref.branch_decode_ref(*args, cap=cap)
    torch.cuda.synchronize()
    err, share = check_close(f"branch_decode_attention {label}", out, want)
    # the work these inputs need: the prefix keys some query of some
    # branch sees, read ONCE; each branch's visible suffix keys
    qpl = qpos.long()[:, :, None]
    pvis = (ppos.long()[:, None, :] >= 0) & (ppos.long()[:, None, :] <= qpl)
    svis = (spos.long()[:, None, :] >= 0) & (spos.long()[:, None, :] <= qpl)
    es = q.element_size()
    nbytes = ((int(pvis.any(1).any(0).sum()) + int(svis.any(1).sum()))
              * 2 * KV * hd * es + 2 * q.numel() * es
              + (ppos.numel() + spos.numel() + qpos.numel()) * 4)
    flops = 4 * hd * Hh * (int(pvis.sum()) + int(svis.sum()))
    bms, by = bound(nbytes, flops, dtype)
    ms = time_ms(lambda: BA.branch_decode_attention(*args, cap=cap))
    plain = time_ms(lambda: ref.branch_decode_ref(*args, cap=cap))
    lib = None
    if cap is None:
        # library yardstick: masked SDPA over the prefix concatenated with
        # each branch's suffix, heads expanded for the group; the
        # concatenation is built outside the timed region
        G = Hh // KV
        kd = torch.cat([pk.expand(kb, -1, -1, -1), sk], 1)
        vd = torch.cat([pv.expand(kb, -1, -1, -1), sv], 1)
        kd = kd.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vd = vd.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        qd = q.transpose(1, 2).contiguous()
        mask = torch.cat([pvis.expand(kb, -1, -1), svis], -1)[:, None]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
    splits = BA.split_plan(kb, Tq, Hh, KV, Sp, Ss,
                           DA.sm_count(q.device))[0]
    return dict(case=label, max_abs_err=err, err_share=share, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                args=args, cap=cap, splits=splits)


def check_single_verify(rng, label, R, V, dtype):
    """The single-request (R, V) verify: accept flags and residual tokens
    equal (a residual may differ only where w lies within BOUNDARY_EPS of
    a cdf boundary), p_tok / q_tok within 1e-6."""
    dev = "cuda"
    pl, ql = (torch.from_numpy(2 * rng.standard_normal((R, V), np.float32)
                               ).to(dev, dtype) for _ in range(2))
    tok = torch.from_numpy(rng.integers(0, V, R).astype(np.int32)).to(dev)
    u, w = (torch.from_numpy(rng.random(R, np.float32)).to(dev)
            for _ in range(2))
    args = (pl, ql, tok, u, w)
    got = [x.cpu() for x in VA.verify_accept(*args)]
    want = [x.cpu() for x in ref.verify_accept_ref(*args)]
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"verify_accept {label}: accept flags differ")
    err = max((got[i] - want[i]).abs().max().item() for i in (2, 3))
    if err > 1e-6:
        raise AssertionError(f"verify_accept {label}: p_tok/q_tok differ "
                             f"by {err:.2e} > 1e-6")
    boundary = 0
    for r in torch.nonzero(got[1] != want[1])[:, 0].tolist():
        if cdf_distance(pl[r], ql[r], got[1][r], want[1][r],
                        w[r]) > BOUNDARY_EPS:
            raise AssertionError(f"verify_accept {label}: residual token "
                                 f"differs at row {r} away from a cdf "
                                 "boundary")
        boundary += 1
    es = pl.element_size()
    bms, by = bound(2 * R * V * es + R * (3 * 4 + 4 * 4), 8 * R * V,
                    torch.float32)
    ms = time_ms(lambda: VA.verify_accept(*args))
    plain = time_ms(lambda: ref.verify_accept_ref(*args))
    # no single PyTorch call computes the verdict: library_ms null
    return dict(case=label, max_abs_err=err, boundary_cases=boundary, ms=ms,
                plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by,
                args=args, splits=VA.split_plan(V, R, DA.sm_count(pl.device)))


def timing_floor(flush: str = "dirty") -> dict:
    """What ``time_ms`` shows for next to no work: a one-element add, and
    a device copy of 10 MB (about the attention kernels' byte bounds);
    each kernel's bound is read against these."""
    one = torch.zeros(1, device="cuda")
    src = torch.ones(5 << 20, dtype=torch.bfloat16, device="cuda")
    dst = torch.empty_like(src)
    out = dict(one_element_ms=time_ms(lambda: one.add_(1.0), flush=flush),
               copy_10mb_ms=time_ms(lambda: dst.copy_(src), flush=flush),
               copy_10mb_bound_ms=2 * src.numel() * 2 / HBM_BYTES_PER_S
               * 1e3)
    log(f"  timing floor ({flush} L2 flush): one-element add "
        f"{out['one_element_ms']:.4f} ms, 10 MB device copy "
        f"{out['copy_10mb_ms']:.4f} ms (bound "
        f"{out['copy_10mb_bound_ms']:.4f})")
    return out


def phase_probe() -> dict:
    """``--probe``: the attention kernels' tile loop timed phase by phase
    at the 7B shapes, from variants built with ``-DREPRO_ATTN_STOP``:
    1 stops every tile after its K/V loads, 2 after its logits, 0 is the
    whole kernel; the timing floor and three kernel calls after a dirty
    L2 flush (the default), a clean one and none; the split plan's size
    knob; the batched verify's rounds (``probe_verify``)."""
    import ctypes
    floor = {f: timing_floor(f) for f in ("dirty", "clean", "none")}
    bf = torch.bfloat16
    rng = np.random.default_rng(0)
    paged = {T: attn_case(rng, 8, T, 32, 32, 128, 16, bf) for T in (1, 8)}
    branch = branch_case(rng, 6, 1, 504, 8, 32, 32, 128, bf)
    flash = {"7B B=1 T=5 S=512": (flash_case(rng, 1, 5, 512, 32, 32, 128,
                                             40, bf, 3), {}),
             "7B B=6 T=10 S=512": (flash_case(rng, 6, 10, 512, 32, 32, 128,
                                              300, bf, 5), {}),
             "7B cache-less T=S=512": (flash_case(rng, 1, 512, 512, 32, 32,
                                                  128, 512, bf), {}),
             "gemma2 window T=16": (flash_case(rng, 1, 16, 4608, 32, 16,
                                               128, 4608, bf),
                                    dict(window=4096))}
    gemma3 = attn_case(rng, 8, 4, 8, 4, 256, 16, bf, max_len=2048,
                       min_len=1500)
    srcs = ("paged_attention.cu", "branch_attention.cu",
            "flash_attention.cu")
    out = {}
    saved = build._lib
    try:
        for stop, what in ((1, "loads only"), (2, "loads + logits"),
                           (0, "whole kernel")):
            build._lib = build.bind(ctypes.CDLL(str(build.build(
                srcs, (f"-DREPRO_ATTN_STOP={stop}",)))))
            for T, a in paged.items():
                ms = time_ms(lambda: PA.paged_attention(*a))
                out[f"paged 7B B=8 T={T} {what}"] = ms
            ms = time_ms(lambda: PA.paged_attention(*gemma3, window=1024))
            out[f"paged gemma3 hd256 B=8 T=4 {what}"] = ms
            ms = time_ms(lambda: BA.branch_decode_attention(*branch))
            out[f"branch 7B k=6 Sp=504 Ss=8 {what}"] = ms
            for name, (a, kw) in flash.items():
                ms = time_ms(lambda: FA.flash_attention(*a, **kw))
                out[f"flash {name} {what}"] = ms
    finally:
        build._lib = saved
    for k, v in out.items():
        log(f"  probe {k:40s} ms={v:.4f}")
    long_row = attn_case(rng, 1, 1, 32, 32, 128, 16, bf, max_len=4096,
                         min_len=3968)
    # the harness's share: the same calls after each flush
    for name, fn in (("paged 7B B=8 T=8", lambda: PA.paged_attention(
                         *paged[8])),
                     ("branch 7B Sp=504", lambda: BA.branch_decode_attention(
                         *branch)),
                     ("paged long row", lambda: PA.paged_attention(
                         *long_row))):
        t = {f: time_ms(fn, flush=f) for f in ("dirty", "clean", "none")}
        out[f"flush {name}"] = t
        log(f"  flush {name:18s} dirty {t['dirty']:.4f} clean "
            f"{t['clean']:.4f} none {t['none']:.4f} ms")
    # the split plan's size knob at the shapes that split
    br2048 = branch_case(rng, 6, 1, 2048, 8, 32, 32, 128, bf)
    sweep = {}
    saved = DA.MIN_SPLIT_KEYS
    try:
        for mk in (128, 256, 512, 1024):
            DA.MIN_SPLIT_KEYS = mk
            for name, fn in (
                    ("paged long row", lambda: PA.paged_attention(
                        *long_row)),
                    ("branch Sp=504", lambda: BA.branch_decode_attention(
                        *branch)),
                    ("branch Sp=2048", lambda: BA.branch_decode_attention(
                        *br2048))):
                sweep[(mk, name)] = time_ms(fn)
    finally:
        DA.MIN_SPLIT_KEYS = saved
    for (mk, name), v in sweep.items():
        log(f"  split sweep min_keys={mk:4d} {name:16s} ms={v:.4f}")
    return dict(floor=floor, phases=out,
                sweep={f"{a} {b}": v for (a, b), v in sweep.items()},
                verify=probe_verify(rng))


def probe_verify(rng) -> dict:
    """The batched verify's rows phase by phase, from variants built with
    ``-DREPRO_VERIFY_STOP``: 1 ends each row after its load, 2 after
    round 1, 3 after round 2, 0 is the whole kernel (each stop adds one
    cluster barrier); and the whole kernel with ten more cluster
    barriers after the load (``-DREPRO_VERIFY_SYNCS=10``), whose
    difference is ten barriers' cost.  V = 32000 (8 blocks a row) with
    16 live rows, phase 2's lens draw (72 of 128 live) and every row
    live; V = 199 (one block a row)."""
    import ctypes

    def case(B, R, V, lens):
        f = [torch.from_numpy(3 * rng.standard_normal((B, R, V), np.float32)
                              ).cuda() for _ in range(2)]
        tok = torch.from_numpy(rng.integers(0, V, (B, R)).astype(np.int32)
                               ).cuda()
        u, w = (torch.from_numpy(rng.random((B, R), np.float32)).cuda()
                for _ in range(2))
        return (*f, tok, torch.tensor(lens, dtype=torch.int32,
                                      device="cuda"), u, w)
    ragged = [10, 14, 8, 3, 11, 12, 14, 0]
    cases = {"V=32000 B=1 R=16 live 16": case(1, 16, 32000, [16]),
             "V=32000 B=8 R=16 live 72": case(8, 16, 32000, ragged),
             "V=32000 B=8 R=16 live 128": case(8, 16, 32000, [16] * 8),
             "V=199 B=8 R=16 live 72": case(8, 16, 199, ragged)}
    variants = (("load", ("-DREPRO_VERIFY_STOP=1",)),
                ("+round 1", ("-DREPRO_VERIFY_STOP=2",)),
                ("+round 2", ("-DREPRO_VERIFY_STOP=3",)),
                ("whole", ()),
                ("+10 barriers", ("-DREPRO_VERIFY_SYNCS=10",)))
    out = {}
    saved = build._lib
    try:
        for what, defines in variants:
            build._lib = build.bind(ctypes.CDLL(str(build.build(
                ("verify_accept.cu",), defines))))
            for name, a in cases.items():
                out[(name, what)] = time_ms(
                    lambda: VA.verify_accept_batched(*a))
    finally:
        build._lib = saved
    for name in cases:
        log(f"  probe verify {name:26s} "
            + " ".join(f"{what} {out[(name, what)]:.4f}"
                       for what, _ in variants) + " ms")
    return {f"{n} {w}": v for (n, w), v in out.items()}


def check_grads(name, got, want) -> float:
    """Hold a backward kernel's gradients against the plain backward's;
    returns the largest error's share of its bound.  f32: 1e-4 x max(1,
    max |want|) (another f32 summation order); bf16: 2^-6 x max |want|
    (a few bf16 spacings at the gradient's scale: both sides read the
    same bf16 inputs, accumulate in f32 and round once)."""
    share = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        lim = (1e-4 * max(1.0, scale) if w.dtype == torch.float32
               else 2.0 ** -6 * scale)
        if not math.isfinite(err) or err > lim:
            raise AssertionError(f"{name}: gradient {i} err {err:.3e} above "
                                 f"{lim:.3e}")
        share = max(share, err / lim)
    return share


def flash_bwd_inputs(rng, B, T, S, H, KV, hd, dtype, frame=None):
    """q, k, v, dO and positions of a training frame: T = S queries at
    positions 0..S-1 over keys at the same positions (``frame``: the
    draft-head loss's layout, (positions, k_pos, q_ctx) as numpy)."""
    dev = "cuda"
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, np.float32)
                                    ).to(dev, dtype)
                   for shape in ((B, T, H, hd), (B, S, KV, hd),
                                 (B, S, KV, hd), (B, T, H, hd)))
    if frame is None:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        qp = kp = torch.from_numpy(np.ascontiguousarray(pos)).to(dev)
        qc = None
    else:
        qp, kp, qc = (torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(x, (B, S)).astype(np.int32))).to(dev)
            for x in frame)
    return q, k, v, do, qp, kp, qc


# ``--flash-bwd``: the frames whose kernels ``bwd_kernel_times`` splits,
# by label (filled by ``check_flash_bwd``)
BWD_SPLIT_CALLS: dict = {}


def bwd_kernel_times(fns: dict, n: int = 5) -> dict:
    """Device ms per call of each kernel each of ``fns`` (label -> call)
    launches (by name), from one CUDA profiler session (a later session
    of a process may lose events) over n back-to-back calls each after
    one warm-up (warm L2); a spin kernel after each frame's calls marks
    where the next frame's begin."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in fns.values():
            for _ in range(n):
                fn()
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.start_ns())
    out = {label: {} for label in fns}
    labels, i = list(fns), 0
    for e in evs:
        if "spin" in e.name():
            i += 1
            continue
        if i >= len(labels):
            break
        m = re.search(r"flash_bwd_\w+?_kernel", e.name())
        k = m.group(0) if m else e.name()[:40]
        d = out[labels[i]]
        d[k] = d.get(k, 0.0) + e.duration_ns() / 1e6 / n
    return out


def check_flash_bwd(rng, label, B, T, S, H, KV, hd, dtype, causal=True,
                    window=0, cap=None, frame=None):
    """The flash backward kernel against ``flash_attention_bwd_ref`` on a
    training frame; its bound is the work the visible (query, key) pairs
    need (five hd-long products each: q.k, dO.v, and the dq, dk and dv
    accumulations; f32 at 3xTF32's rate, and at the CUDA cores' f32 rate
    beside it) or the bytes of q, k, v, o, dO in and dq, dk, dv out;
    the library figure is SDPA's forward and backward over the same
    visibility mask (none with a softcap, which SDPA lacks), and beside it
    SDPA's backward alone (its forward and graph built outside the timed
    window: the like-for-like figure for a backward).  Also: the bound's
    work over the kernel's time (TFLOP/s) and the kernels' blocks
    (``FA.bwd_plan``; absent from an older checkout's port)."""
    q, k, v, do, qp, kp, qc = flash_bwd_inputs(rng, B, T, S, H, KV, hd,
                                               dtype, frame)
    kw = dict(causal=causal, window=window, cap=cap, q_ctx=qc)
    o = FA.flash_attention(q, k, v, qp, kp, **kw)
    got = FA.flash_attention_bwd(q, k, v, o, do, qp, kp, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, qp, kp, **kw)
    torch.cuda.synchronize()
    share = check_grads(f"flash_attention_bwd {label}", got, want)
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    kpl = kp.long()[:, None, :]
    qcl = (qc if qc is not None else qp).long()[:, :, None]
    vis = ((kpl >= 0) & ((kpl <= qcl) if causal else True)).expand(
        B, T, S)
    if window > 0:
        vis = vis & ((qp.long()[:, :, None] - kpl) < window)
    G = H // KV
    es = q.element_size()
    nbytes = (4 * q.numel() + 4 * k.numel()) * es + 3 * qp.numel() * 4
    work = 10 * hd * int(vis.sum()) * H
    f32 = dtype == torch.float32
    bms, by = bound(nbytes, work, dtype, PEAK_3XTF32 if f32 else 0.0)
    cc_bms = bound(nbytes, work, dtype)[0] if f32 else None
    ms = time_ms(lambda: FA.flash_attention_bwd(q, k, v, o, do, qp, kp,
                                                **kw))
    plain = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, qp,
                                                        kp, **kw))
    width = (DA.head_dim_path("bwd", hd, q, k, v)[0]
             if hasattr(DA, "head_dim_path") else hd)
    blocks = (FA.bwd_plan(B, T, S, H, KV, width, dtype)["blocks"]
              if hasattr(FA, "bwd_plan") else None)
    if "--flash-bwd" in sys.argv and label in BWD_SPLIT_FRAMES:
        BWD_SPLIT_CALLS[label] = lambda: FA.flash_attention_bwd(
            q, k, v, o, do, qp, kp, **kw)
    lib = lib_bwd = None
    if cap is None:
        qd = q.transpose(1, 2).contiguous().requires_grad_(True)
        kd = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous() \
            .requires_grad_(True)
        vd = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous() \
            .requires_grad_(True)
        dod = do.transpose(1, 2).contiguous()
        mask = vis[:, None]

        def sdpa():
            out = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
            torch.autograd.grad(out, (qd, kd, vd), dod)
        lib = time_ms(sdpa)
        out = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            out, (qd, kd, vd), dod, retain_graph=True))
        del out
    return dict(case=label, max_abs_err=err, err_share=share, ms=ms,
                plain_ms=plain, library_ms=lib, sdpa_bwd_ms=lib_bwd,
                bound_ms=bms, bound_by=by, cuda_core_bound_ms=cc_bms,
                tflops=work / ms / 1e9, blocks=blocks, split=None)


def check_ssm_bwd(rng, label, B, T, E, N, xdtype):
    """The scan backward kernel against ``ssm_scan_bwd_ref`` from the
    forward kernel's chunk checkpoints (an older checkout's port, under
    ``--src``: from its states mode's hs), on inputs shaped like a Mamba
    layer's (as ``check_ssm``), with and without a gradient on hT; two
    launches give the same bits, and the chunk mode's hc is the states
    mode's hs at the chunk boundaries.  Bound: the bytes the design must
    move (x, dt, dy, B, C, A, D and the saved states in, the gradients
    out), and beside it the same with the every-state hs saved."""
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).cuda()
    x = f(B, T, E).to(xdtype)
    dt = F.softplus(f(B, T, E))
    Bm, Cm, h0 = f(B, T, N), f(B, T, N), f(B, E, N)
    A = -torch.exp(f(E, N) * 0.2)
    D = torch.ones(E, device="cuda")
    ins = (x, dt, Bm, Cm, A, D, h0)
    chunked = hasattr(SS, "scan_chunk")
    _y, _hT, hs = SS.ssm_scan(*ins, return_states=True)
    if chunked:
        K = SS.scan_chunk()
        _y, _hT, saved = SS.ssm_scan(*ins, chunks=True)
        torch.cuda.synchronize()
        if not (torch.equal(saved[:, 0], h0) and all(
                torch.equal(saved[:, k], hs[:, k * K - 1])
                for k in range(1, saved.shape[1]))):
            raise AssertionError(f"ssm_scan chunks {label}: hc is not hs at "
                                 "the chunk boundaries")
        refkw = dict(chunk=K)
        C = 128 // (N // 4)
        blocks = -(-E // C) * -(-T // K) * B
    else:
        saved, refkw, blocks = hs, {}, None
    hs_bytes, h0_bytes = hs.numel() * 4, h0.numel() * 4
    del hs
    dy, dhT = f(B, T, E), f(B, E, N)
    args = ins + (saved, dy)
    share, err = 0.0, 0.0
    for dh in (None, dhT):
        got = SS.ssm_scan_bwd(*args, dh)
        want = ref.ssm_scan_bwd_ref(*args, dh, **refkw)
        again = SS.ssm_scan_bwd(*args, dh)
        torch.cuda.synchronize()
        share = max(share, check_grads(f"ssm_scan_bwd {label}", got, want))
        err = max([err] + [(g.float() - w.float()).abs().max().item()
                           for g, w in zip(got, want)])
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"ssm_scan_bwd {label}: two launches "
                                 "differ")
    outs = SS.ssm_scan_bwd(*args, None)
    io = sum(t.numel() * t.element_size() for t in ins[:6] + (dy,) + outs)
    work = 20 * B * T * E * N
    saved_bytes = saved.numel() * 4 + (0 if chunked else h0_bytes)
    bms, by = bound(io + saved_bytes, work, torch.float32)
    hs_bms = bound(io + hs_bytes + h0_bytes, work, torch.float32)[0]
    ms = time_ms(lambda: SS.ssm_scan_bwd(*args, None))
    plain = time_ms(lambda: ref.ssm_scan_bwd_ref(*args, None, **refkw),
                    iters=5, warmup=1)
    # no single PyTorch call computes a selective scan's backward
    return dict(case=label, max_abs_err=err, err_share=share, ms=ms,
                plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by,
                hs_bound_ms=hs_bms, saved_mb=saved_bytes / 1e6,
                hs_mb=hs_bytes / 1e6, blocks=blocks)


def scan_bwd_cases(rng) -> list:
    """Phase 2's scan backward cases: falcon-mamba-7b's training frame, a
    tiny f32 one, T = 250 (not a multiple of the chunk), T = 20 (shorter
    than one) and B = 2, at falcon's width but the tiny one."""
    bf, f32 = torch.bfloat16, torch.float32
    return [check_ssm_bwd(rng, SCAN_BWD_CASE, 1, 256, 8192, 16, bf),
            check_ssm_bwd(rng, "tiny f32 B=16 T=64 E=128", 16, 64, 128, 16,
                          f32),
            check_ssm_bwd(rng, "falcon-7b B=1 T=250 E=8192", 1, 250, 8192,
                          16, bf),
            check_ssm_bwd(rng, "falcon-7b B=1 T=20 E=8192", 1, 20, 8192, 16,
                          bf),
            check_ssm_bwd(rng, "falcon-7b B=2 T=256 E=8192", 2, 256, 8192,
                          16, bf)]


def log_scan_bwd_rows(rows) -> None:
    """The scan backward cases' extra columns: the bound had the every-state
    hs been saved, the saved states' MB against hs's, the main stage's
    blocks."""
    for r in rows:
        log(f"  {r['case']:32s} ms={r['ms']:.4f} bound={r['bound_ms']:.4f} "
            f"hs_bound={r['hs_bound_ms']:.4f}; saved {r['saved_mb']:.2f} MB "
            f"(hs {r['hs_mb']:.2f} MB); blocks {r['blocks']}; err "
            f"{r['err_share']:.3f} of its bound")


def phase_scan_bwd() -> None:
    """``--scan-bwd``: phase 2's scan backward cases alone (with ``--src``,
    of another checkout's kernel), the training forward's states and chunk
    modes, and (this checkout's port) ``probe_scan_bwd``."""
    rng = np.random.default_rng(0)
    rows = scan_bwd_cases(rng)
    fwd = train_fwd_cases(rng)
    timing_floor()
    log_scan_bwd_rows(rows)
    for r in fwd:
        log(f"  {r['case']:32s} ms={r['ms']:.4f} bound={r['bound_ms']:.4f}")
    if hasattr(SS, "scan_chunk"):
        probe_scan_bwd()


def probe_scan_bwd() -> None:
    """The backward at falcon's training frame phase by phase, from
    variants built with -DREPRO_SCAN_BWD_STOP (1: the carry stage only;
    2: the main stage's staging copies only; 3: all but the reduction),
    and whole with the other chunk lengths of 16, 32 and 64 steps
    (-DREPRO_SCAN_CHUNK), beside this build's whole call."""
    import ctypes
    rng = np.random.default_rng(1)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).cuda()
    B, T, E, N = 1, 256, 8192, 16
    ins = (f(B, T, E).to(torch.bfloat16), F.softplus(f(B, T, E)),
           f(B, T, N), f(B, T, N), -torch.exp(f(E, N) * 0.2),
           torch.ones(E, device="cuda"), f(B, E, N))
    dy = f(B, T, E)

    def call():
        hc = SS.ssm_scan(*ins, chunks=True)[2]
        return lambda: SS.ssm_scan_bwd(*ins, hc, dy)
    K = SS.scan_chunk()
    out = {f"whole (K={K})": time_ms(call())}
    saved = build._lib
    try:
        for defines, what in (
                (("-DREPRO_SCAN_BWD_STOP=1",), "carry stage only"),
                (("-DREPRO_SCAN_BWD_STOP=2",), "main-stage staging only"),
                (("-DREPRO_SCAN_BWD_STOP=3",), "without the reduction"),
                *(((f"-DREPRO_SCAN_CHUNK={k}",), f"whole (K={k})")
                  for k in (16, 32, 64) if k != K)):
            build._lib = build.bind(ctypes.CDLL(str(build.build(
                ("ssm_scan.cu", "ssm_scan_bwd.cu"), defines))))
            out[what] = time_ms(call())
    finally:
        build._lib = saved
    for k, v in out.items():
        log(f"  scan-bwd probe {SCAN_BWD_CASE}: {k:24s} ms={v:.4f}")


def draft_frame(Lp: int, K: int, A: int):
    """The draft-head loss's frame (``training.train.draft_head_loss``):
    Lp real columns, then A groups of K slot columns whose keys are
    invisible and whose queries see up to their anchor.  Returns
    (positions, k_pos, q_ctx) as numpy."""
    from repro_torch.training.train import head_anchors
    anc = np.repeat(np.asarray(head_anchors(Lp, K)), K)[:A * K]
    off = np.tile(np.arange(K), A)
    t = np.arange(Lp)
    pos = np.concatenate([t, anc + 1 + off])
    kpos = np.concatenate([t, np.full(A * K, -1)])
    ctx = np.concatenate([t, anc])
    return pos, kpos, ctx


def flash_bwd_cases(rng) -> list:
    """Phase 2's flash backward cases: the tiny pair's training frame,
    gemma3-4b's (window 1024 and global), a softcap (gemma2-27b's heads),
    hubert's bidirectional frame and the tiny draft's head-loss frame
    (invisible slot keys, clamped queries)."""
    bf, f32 = torch.bfloat16, torch.float32
    fl = [check_flash_bwd(rng, TINY_BWD_CASE, 16, 63, 63, 4, 2, 32, f32),
          check_flash_bwd(rng, FLASH_BWD_CASE, 1, 1280, 1280, 8, 4, 256, bf,
                          window=1024),
          check_flash_bwd(rng, "gemma3-4b train B=1 T=S=1280 global", 1,
                          1280, 1280, 8, 4, 256, bf),
          check_flash_bwd(rng, "gemma2 cap B=1 T=S=512 w4096", 1, 512, 512,
                          32, 16, 128, bf, window=4096, cap=50.0),
          check_flash_bwd(rng, "hubert-xl hd80 B=2 T=S=500 bidir", 2, 500,
                          500, 16, 16, 80, bf, causal=False)]
    Lp, K = 64, 4
    frame = draft_frame(Lp, K, 8)
    T = len(frame[0])
    fl.append(check_flash_bwd(rng, f"zm-draft head loss B=16 T=S={T}", 16,
                              T, T, 2, 1, 16, f32, frame=frame))
    return fl


def log_bwd_rows(rows) -> None:
    """The flash backward cases' columns: the kernel's, the plain
    version's and SDPA's times (forward + backward, and its backward
    alone), the bound (at f32 also the bound at the CUDA cores' f32 rate,
    as rows before the 3xTF32 design gave it), the bound's work over the
    kernel's time and the kernels' blocks."""
    def fmt(x):
        return "null" if x is None else f"{x:.4f}"
    for r in rows:
        log(f"  {r['case']:32s} ms={r['ms']:.4f} "
            f"plain={r['plain_ms']:.4f} bound={r['bound_ms']:.4f} "
            f"({r['bound_by']}) "
            + ("" if r["cuda_core_bound_ms"] is None else
               f"bound_cuda_core={r['cuda_core_bound_ms']:.4f} ")
            + f"sdpa_fwd_bwd={fmt(r['library_ms'])} "
            f"sdpa_bwd={fmt(r['sdpa_bwd_ms'])} "
            f"{r['tflops']:.1f} TFLOP/s of the bound's work; "
            f"blocks {r['blocks']}; err {r['err_share']:.3f} of its bound"
            + ("" if r["split"] is None else "; by kernel (warm L2) " +
               " ".join(f"{k} {v:.4f}" for k, v in r["split"].items())))


def phase_flash_bwd() -> None:
    """``--flash-bwd``: phase 2's flash backward cases and granite's draft
    frame at bf16 and f32 alone (with ``--src``, of another checkout's
    kernel), the kernels' device time at gemma3-4b's window frame, the
    tiny pair's and granite's f32 frame from one profiler session,
    ``probe_flash_bwd`` and (absent from an older checkout's port: no f32
    tiles) ``probe_flash_bwd_f32``."""
    rng = np.random.default_rng(0)
    rows = flash_bwd_cases(rng)
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt is torch.bfloat16 else "f32"
        rows.append(check_flash_bwd(rng, GRANITE_BWD_CASE.format(tag), 1,
                                    256, 256, 3, 3, 85, dt))
    timing_floor()
    split = bwd_kernel_times(BWD_SPLIT_CALLS)
    BWD_SPLIT_CALLS.clear()
    for r in rows:
        r["split"] = split.get(r["case"])
    log_bwd_rows(rows)
    if hasattr(FA, "bwd_plan"):
        probe_flash_bwd()
    if hasattr(FA, "F32_TARGET"):
        probe_flash_bwd_f32()


def probe_flash_bwd() -> None:
    """The bf16 backward at gemma3-4b's window frame phase by phase, from
    variants built with -DREPRO_BWD_STOP (1: every tile stops after its
    copies; 3: the copies of every tile after the first skipped, compute
    alone; 4: the dk/dv kernel left out), beside the whole call and the
    whole call at B=2 per item (how far one item is from filling the
    card)."""
    import ctypes
    rng = np.random.default_rng(1)
    frames = {}
    for B in (1, 2):
        q, k, v, do, qp, kp, _ = flash_bwd_inputs(rng, B, 1280, 1280, 8, 4,
                                                  256, torch.bfloat16)
        o = FA.flash_attention(q, k, v, qp, kp, window=1024)
        frames[B] = (q, k, v, o, do, qp, kp)

    def call(B):
        return lambda: FA.flash_attention_bwd(*frames[B], window=1024)
    out = {"whole": time_ms(call(1)),
           "whole at B=2, per item": time_ms(call(2)) / 2}
    saved = build._lib
    try:
        for stop, what in ((1, "copies only"), (3, "compute only"),
                           (4, "without the dk/dv kernel")):
            build._lib = build.bind(ctypes.CDLL(str(build.build(
                ("flash_attention_bwd.cu",), (f"-DREPRO_BWD_STOP={stop}",)))))
            out[what] = time_ms(call(1))
    finally:
        build._lib = saved
    for k, v in out.items():
        log(f"  flash-bwd probe {FLASH_BWD_CASE}: {k:26s} ms={v:.4f}")


def probe_flash_bwd_f32() -> None:
    """The f32 backward at the tiny pair's, the draft-head loss's and
    granite's draft's training frames, whole and from variants built with
    -DREPRO_BWD_STOP (1: copies only; 3: compute only; 4: without the
    dk/dv kernel)."""
    import ctypes
    rng = np.random.default_rng(2)
    f32 = torch.float32
    Lp, K = 64, 4
    frame = draft_frame(Lp, K, 8)
    T = len(frame[0])
    frames = {}
    for label, args, fr in (("tiny", (16, 63, 63, 4, 2, 32), None),
                            ("draft-head", (16, T, T, 2, 1, 16), frame),
                            ("granite", (1, 256, 256, 3, 3, 85), None)):
        q, k, v, do, qp, kp, qc = flash_bwd_inputs(rng, *args, f32, fr)
        o = FA.flash_attention(q, k, v, qp, kp, q_ctx=qc)
        frames[label] = (q, k, v, o, do, qp, kp, qc)

    def times():
        return {lab: time_ms(lambda: FA.flash_attention_bwd(
            *x[:7], q_ctx=x[7])) for lab, x in frames.items()}
    out = {"whole": times()}
    saved = build._lib
    srcs = ("flash_attention_bwd.cu", "flash_attention_bwd_f32.cu",
            "flash_attention_bwd_f32_ragged.cu")
    try:
        for stop, what in ((1, "copies only"), (3, "compute only"),
                           (4, "without the dk/dv kernel")):
            build._lib = build.bind(ctypes.CDLL(str(build.build(
                srcs, (f"-DREPRO_BWD_STOP={stop}",)))))
            out[what] = times()
    finally:
        build._lib = saved
    for k, v in out.items():
        log(f"  flash-bwd f32 probe {k:28s} " + " ".join(
            f"{lab} ms={ms:.4f}" for lab, ms in v.items()))


def phase_kernels_bwd(rng) -> dict:
    """Phase 2's backward cases: ``flash_bwd_cases``, then
    ``scan_bwd_cases``."""
    fl = flash_bwd_cases(rng)
    return {"flash_attention_bwd": fl, "ssm_scan_bwd": scan_bwd_cases(rng)}


def phase_kernel_api(cases, totals) -> dict:
    """The path of the two kernels no engine calls, in either package: the
    kernel API ``kernels.ops``, driven once per checked shape (as the
    reference's benchmarks/kernels_bench.py drives ``repro.kernels.ops``),
    the counters zeroed just before and read just after."""
    ops.reset_launches()
    for c in cases["branch_decode_attention"]:
        ops.branch_decode_attention(*c["args"], cap=c["cap"])
    for c in cases["verify_accept"]:
        ops.verify_accept(*c["args"])
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    for k, v in counts.items():
        totals[k] += v
    log(f"  kernel API drive: launches={counts}")
    for k in ("branch_decode_attention", "verify_accept"):
        if counts[k] == 0:
            raise AssertionError(f"kernel API drive: {k} not launched")
    return counts


def ragged_cases(rng) -> dict:
    """Phase 2's cases on the decode loop's ragged path, by kernel: at
    granite-moe-3b-a800m's draft() shapes (3 heads of hd 85, rows of 170
    bytes in bf16, 340 in f32; width 96), bf16 and f32 -- paged at B=8,
    T=4 over a 1040-key table, flash on a ring of those shapes and
    cache-less over phase 15's 256-token prompts (the wide block), branch
    decode k=6 over a 504-key prefix, the backward at the training frame
    B=1, T=S=256 -- and hd 200 (width 256) at one shape each in bf16;
    beside them the paged and flash shapes at the aligned hd 64 and 128
    (bf16)."""
    bf, f32 = torch.bfloat16, torch.float32
    att, fl, br, bw = [], [], [], []
    for dt in (bf, f32):
        tag = f"granite draft hd85 {'bf16' if dt is bf else 'f32'}"
        att.append(check_attention(rng, f"{tag} B=8 T=4", 8, 4, 3, 3, 85,
                                   16, dt, max_len=1040, min_len=1000,
                                   n_max=65))
        fl.append(check_flash(rng, f"{tag} ring B=8 T=4 S=1040", 8, 4,
                              1040, 3, 3, 85, 1030, dt))
        fl.append(check_flash(rng, f"{tag} cache-less B=8 T=S=256", 8, 256,
                              256, 3, 3, 85, 256, dt))
        br.append(check_branch(rng, f"{tag} k=6 Sp=504 Ss=8", 6, 1, 504, 8,
                               3, 3, 85, dt))
        bw.append(check_flash_bwd(rng, f"{tag} train B=1 T=S=256", 1, 256,
                                  256, 3, 3, 85, dt))
    att.append(check_attention(rng, "hd200 bf16 B=8 T=4", 8, 4, 4, 2, 200,
                               16, bf, max_len=1040, min_len=1000, n_max=65))
    fl.append(check_flash(rng, "hd200 bf16 ring B=8 T=4 S=1040", 8, 4, 1040,
                          4, 2, 200, 1030, bf))
    br.append(check_branch(rng, "hd200 bf16 k=6 Sp=504 Ss=8", 6, 1, 504, 8,
                           4, 2, 200, bf))
    bw.append(check_flash_bwd(rng, "hd200 bf16 train B=1 T=S=256", 1, 256,
                              256, 4, 2, 200, bf))
    for hd in (64, 128):
        att.append(check_attention(rng, f"granite draft at hd{hd} bf16 B=8 "
                                   "T=4", 8, 4, 3, 3, hd, 16, bf,
                                   max_len=1040, min_len=1000, n_max=65))
        fl.append(check_flash(rng, f"granite draft at hd{hd} bf16 ring B=8 "
                              "T=4 S=1040", 8, 4, 1040, 3, 3, hd, 1030, bf))
    return {"paged_attention": att, "flash_attention": fl,
            "branch_decode_attention": br, "flash_attention_bwd": bw}


def phase_attn() -> None:
    """``--attn``: phase 2's aligned attention cases alone
    (``attention_cases``), of this or (``--src``) another checkout's port,
    one line a case: the aligned path's A/B."""
    att, fl, br = attention_cases(np.random.default_rng(0))
    timing_floor()
    for r in att + fl + br:
        log(f"  attn-ab {r['case']:44s} ms={r['ms']:.4f} "
            f"bound={r['bound_ms']:.4f}")


def attention_cases(rng) -> tuple:
    """Phase 2's paged, flash and branch-decode cases on the decode
    loop's aligned path (the head dims of ``DA.HEAD_DIMS`` over 16-byte
    aligned rows): (paged, flash, branch) rows.  ``--attn`` runs them
    alone, of this or (``--src``) another checkout's port: the aligned
    path's A/B."""
    bf, f32 = torch.bfloat16, torch.float32
    att = []
    for T in (1, 2, 4, 8, 16):
        att.append(check_attention(rng, f"llama-7b B=8 T={T}", 8, T, 32, 32,
                                   128, 16, bf))
    # one rank's head shard of the 7B at tp = 2 (phase 17's mesh serve)
    att.append(check_attention(rng, "llama-7b tp2 shard B=8 T=8", 8, 8, 16,
                               16, 128, 16, bf))
    for T in (1, 16):
        att.append(check_attention(rng, f"llama-68m B=56 T={T}", 56, T, 12,
                                   12, 64, 16, bf, n_idle=40))
    for T in (1, 4, 16):
        att.append(check_attention(rng, f"zm-target B=8 T={T}", 8, T, 4, 2,
                                   32, 16, f32))
    att.append(check_attention(rng, "zm-target B=8 T=8 ps=4", 8, 8, 4, 2,
                               32, 4, f32))
    for T in (1, 16):
        att.append(check_attention(rng, f"zm-draft B=56 T={T}", 56, T, 2, 1,
                                   16, 16, f32, n_idle=40))
    fl = [check_flash(rng, "llama-7b B=1 T=1 S=512", 1, 1, 512, 32, 32, 128,
                      48, bf),
          check_flash(rng, "llama-7b B=1 T=5 S=512", 1, 5, 512, 32, 32, 128,
                      40, bf, stale=3),
          check_flash(rng, "llama-7b B=6 T=1 S=512", 6, 1, 512, 32, 32, 128,
                      41, bf),
          check_flash(rng, "llama-7b B=6 T=10 S=512", 6, 10, 512, 32, 32,
                      128, 300, bf, stale=5),
          check_flash(rng, "llama-7b prefill B=1 T=15", 1, 15, 512, 32, 32,
                      128, 15, bf),
          check_flash(rng, "llama-7b cache-less B=2 T=S=48", 2, 48, 48, 32,
                      32, 128, 48, bf),
          check_flash(rng, "llama-68m B=6 T=1 S=512", 6, 1, 512, 12, 12, 64,
                      41, bf),
          check_flash(rng, "llama-68m B=1 T=1 S=512", 1, 1, 512, 12, 12, 64,
                      44, bf),
          check_flash(rng, "zm-target B=1 T=5 S=512", 1, 5, 512, 4, 2, 32,
                      40, f32, stale=3),
          check_flash(rng, "zm-draft B=6 T=1 S=512", 6, 1, 512, 2, 1, 16,
                      41, f32),
          check_flash(rng, "gemma2 window B=1 T=1 S=4608", 1, 1, 4608, 32,
                      16, 128, 4608, bf, window=4096, cap=50.0),
          check_flash(rng, "gemma2 window B=1 T=16 S=4608", 1, 16, 4608, 32,
                      16, 128, 4608, bf, window=4096, cap=50.0),
          check_flash(rng, "gemma2 window B=1 T=16 f32", 1, 16, 4608, 32, 16,
                      128, 4608, f32, window=4096, cap=50.0)]
    br = [check_branch(rng, "llama-7b k=6 Sp=504 Ss=8", 6, 1, 504, 8, 32,
                       32, 128, bf),
          check_branch(rng, "tiny f32 k=3 Tq=3 Sp=29 Ss=5", 3, 3, 29, 5, 4,
                       2, 32, f32, dead=2),
          check_branch(rng, "llama-7b cap k=6 Sp=504 Ss=8", 6, 1, 504, 8,
                       32, 32, 128, bf, cap=50.0)]
    # cases after the earlier slices' (their inputs stay the same draws):
    # page tables as wide as a serve's, a long row at B = 1 and a long
    # shared prefix, which split the key axis
    for T in (1, 5):
        att.append(check_attention(rng, f"llama-7b B=8 T={T} 32-page table",
                                   8, T, 32, 32, 128, 16, bf, n_max=32))
    att.append(check_attention(rng, "llama-68m B=56 T=1 32-page table", 56,
                               1, 12, 12, 64, 16, bf, n_idle=40, n_max=32))
    att.append(check_attention(rng, "llama-7b B=1 T=1 long row", 1, 1, 32,
                               32, 128, 16, bf, max_len=4096,
                               min_len=3968))
    br.append(check_branch(rng, "llama-7b k=6 Sp=2048 Ss=8", 6, 1, 2048, 8,
                           32, 32, 128, bf))
    # head dims 80 and 256 on the decode loop, a 512-token cache-less
    # prefill and the long windowed row without a cap (SDPA's yardstick)
    fl.append(check_flash(rng, "llama-7b cache-less B=1 T=S=512", 1, 512,
                          512, 32, 32, 128, 512, bf))
    fl.append(check_flash(rng, "gemma2 window B=1 T=16 no cap", 1, 16, 4608,
                          32, 16, 128, 4608, bf, window=4096))
    fl.append(check_flash(rng, "gemma3-4b window B=1 T=5 S=2048", 1, 5, 2048,
                          8, 4, 256, 1800, bf, stale=3, window=1024))
    fl.append(check_flash(rng, "hubert-xl hd80 B=2 T=S=256 bidir", 2, 256,
                          256, 16, 16, 80, 256, bf, causal=False))
    att.append(check_attention(rng, "gemma3-4b B=8 T=4 window 1024", 8, 4, 8,
                               4, 256, 16, bf, window=1024, max_len=2048,
                               min_len=1500))
    br.append(check_branch(rng, "gemma3-4b k=6 Sp=504 Ss=8", 6, 1, 504, 8,
                           8, 4, 256, bf))
    br.append(check_branch(rng, "hd80 H=16 k=6 Sp=504 Ss=8", 6, 1, 504, 8,
                           16, 16, 80, bf))
    # the dense backend's flash shapes (phase 11's 7B serve: the target's
    # 8 rows verifying a bucket-8 chunk and prefilling a 16-wide rung on a
    # fresh 512-slot view, the 68M draft's 56 rows ticking)
    fl.append(check_flash(rng, "llama-7b dense B=8 T=8 S=512", 8, 8, 512,
                          32, 32, 128, 40, bf, stale=4))
    fl.append(check_flash(rng, "llama-7b dense prefill B=8 T=16 S=512", 8,
                          16, 512, 32, 32, 128, 16, bf))
    fl.append(check_flash(rng, "llama-68m dense B=56 T=1 S=512", 56, 1,
                          512, 12, 12, 64, 41, bf))
    # the parallel-draft frames (phase 13): the 68M draft's B=8 rows (SpS)
    # and 56 rows, 40 idle (SpecBranch), T = 16 (pending + slots on the
    # bucket ladder), S = 512; the tiny draft's f32 frame
    nr8 = [1, 2, 5, 1, 3, 9, 1, 2]
    fl.append(check_flash_frame(rng, "llama-68m frame B=8 T=16 S=512", 8,
                                16, 512, 12, 12, 64, 41, bf, nr8))
    fl.append(check_flash_frame(rng, "zm-draft frame B=8 T=16 S=512", 8,
                                16, 512, 2, 1, 16, 41, f32, nr8))
    att.append(check_attention(rng, "llama-68m frame B=8 T=16", 8, 16, 12,
                               12, 64, 16, bf, n_max=32, nreal=nr8))
    att.append(check_attention(rng, "llama-68m frame B=56 T=16", 56, 16,
                               12, 12, 64, 16, bf, n_idle=40, n_max=32,
                               nreal=nr8 * 7))
    att.append(check_attention(rng, "zm-draft frame B=8 T=16", 8, 16, 2, 1,
                               16, 16, f32, nreal=nr8))
    # the prefix cache's suffix prefill (phase 14): the 7B followers' frame
    # (7 lanes of a 31-token suffix on the 32-token rung, queries from
    # the 512-token cached run whose 32 pages every row's table shares,
    # one pad lane; tables of the serve's 1024-token width) and the tiny
    # pair's f32 frame (8 cached tokens, a 2-token suffix on the 8 rung,
    # page size 4)
    att.append(check_attention(rng, PC_ATTN_CASE, 8, 32, 32, 32, 128, 16,
                               bf, n_idle=1, n_max=64, prefix=(512, 31)))
    att.append(check_attention(rng, "zm-target suffix B=4 T=8 q0=8 ps=4", 4,
                               8, 4, 2, 32, 4, f32, n_idle=1,
                               prefix=(8, 2)))
    # the draft() head dims (phase 15): gemma3-4b's draft (2 heads of 160)
    # and gemma2-27b's (4 heads of 144), bf16 and f32 -- paged at B=8,
    # T=4, window 1024 over a 1040-key table, flash on a ring of those
    # shapes, branch decode k=6 over a 504-key prefix -- with the paged
    # shape at hd 128 and 256 beside them; hubert's 500-frame forward
    for hd, H in ((160, 2), (144, 4)):
        for dt in (bf, f32):
            tag = f"hd{hd} {'bf16' if dt is bf else 'f32'}"
            att.append(check_attention(rng, f"draft {tag} B=8 T=4 w1024", 8,
                                       4, H, H, hd, 16, dt, window=1024,
                                       max_len=1040, min_len=1000,
                                       n_max=65))
            fl.append(check_flash(rng, f"draft {tag} ring B=8 T=4 S=1040",
                                  8, 4, 1040, H, H, hd, 1030, dt,
                                  window=1024))
            br.append(check_branch(rng, f"draft {tag} k=6 Sp=504 Ss=8", 6,
                                   1, 504, 8, H, H, hd, dt))
    for hd in (128, 256):
        att.append(check_attention(rng, f"draft hd{hd} bf16 B=8 T=4 w1024",
                                   8, 4, 2, 2, hd, 16, bf, window=1024,
                                   max_len=1040, min_len=1000, n_max=65))
    fl.append(check_flash(rng, HUBERT_CASE, 2, 500, 500, 16, 16, 80, 500,
                          bf, causal=False))
    # gemma3-4b's prefill rung (phase 15: 8 lanes of 1000-token prompts,
    # queries from position 0), bf16: paged over the serve's 128-page
    # tables for the target's local (window 1024) and global layers and
    # the draft's local ones; flash on the dense backend's fresh view
    # (local rings of 1024 + 92 slack slots, global layers of max_len
    # 2048) and the sequential runner's B = 1 global layer
    for label, H, KV, hd, w in (("gemma3-4b w1024", 8, 4, 256, 1024),
                                ("gemma3-4b global", 8, 4, 256, 0),
                                ("draft hd160 w1024", 2, 2, 160, 1024)):
        att.append(check_attention(rng, f"{label} prefill B=8 T=1000", 8,
                                   1000, H, KV, hd, 16, bf, window=w,
                                   max_len=1000, min_len=1000, n_max=128))
        S = 1116 if w else 2048
        fl.append(check_flash(rng, f"{label} prefill B=8 T=1000 S={S}", 8,
                              1000, S, H, KV, hd, 1000, bf, window=w))
    fl.append(check_flash(rng, "gemma3-4b global prefill B=1 T=1000 S=2048",
                          1, 1000, 2048, 8, 4, 256, 1000, bf))
    return att, fl, br

def phase_kernels() -> dict:
    rng = np.random.default_rng(0)
    bf, f32 = torch.bfloat16, torch.float32
    att, fl, br = attention_cases(rng)
    rag = ragged_cases(rng)
    att += rag["paged_attention"]
    fl += rag["flash_attention"]
    br += rag["branch_decode_attention"]
    ver = [check_verify(rng, "llama V=32000 B=8 R=16", 8, 16, 32000),
           check_verify(rng, "zm V=199 B=8 R=16", 8, 16, 199)]
    gat = [check_gather(rng, "zm swap ps=4 dim=512", 64, 4, 512, 13, 50),
           check_gather(rng, "llama-7b swap ps=16 dim=262144", 8, 16,
                        262144, 5, 70)]
    bf16 = torch.bfloat16
    ss = [check_ssm(rng, "falcon-7b decode B=8 T=8", 8, 8, 8192, 16, bf16,
                    True),
          check_ssm(rng, "falcon-7b prefill B=8 T=16", 8, 16, 8192, 16,
                    bf16, True),
          check_ssm(rng, "falcon draft tick B=56 T=1", 56, 1, 1024, 16,
                    bf16, True),
          check_ssm(rng, "falcon-7b cache-less B=8 T=48", 8, 48, 8192, 16,
                    bf16, False),
          check_ssm(rng, "tiny f32 B=3 T=8 E=128", 3, 8, 128, 16, f32,
                    True),
          check_ssm(rng, "odd length B=1 T=130 E=32 N=8", 1, 130, 32, 8,
                    f32, True)]
    sv = [check_single_verify(rng, "llama V=32000 R=9", 9, 32000, f32)]
    # the scan's ring entry at the falcon-mamba-7b serve's two target
    # shapes (8 lanes of T = 16, its most frequent, and of T = 8, over 8
    # ring rows of depth FALCON_RING; two fresh lanes, two wrapping past
    # slot Rg - 1, one pad lane) and a lapping prefill; the verify with
    # every row full, with a V its split does not divide, and at gemma3-4b's
    # vocabulary (16 blocks per row, the non-portable cluster)
    rr = falcon_ring_cases(rng) + [
        check_ssm_ring(rng, "lapping prefill B=4 T=130 E=1024 Rg=92", 4,
                       130, 1024, 16, 92, 6, bf16, p0=[0, 0, 7, 0],
                       rows=[4, 1, 0, -1])]
    ver.append(check_verify(rng, "llama V=32000 B=8 R=16 full", 8, 16,
                            32000, lens_to=16))
    ver.append(check_verify(rng, "V=30011 B=8 R=16", 8, 16, 30011))
    ver.append(check_verify(rng, "gemma3-4b V=262144 B=4 R=6", 4, 6,
                            262144))
    ss += carry_cases(rng) + [train_fwd_chunks(rng)]
    # the swap readback at the 7B target's full width (4 pages of 16, 60
    # rows) and the ring scan's suffix entry (phase 14) at falcon's width
    # from a restored slot at p0 = 256 (3 hit lanes and a pad lane, rungs
    # 16 and 32)
    gat.append(check_gather(rng, GATHER_FULL_CASE, 8, 16, 262144, 4, 60))
    for T in (16, 32):
        rr.append(check_ssm_ring(rng, f"falcon-7b suffix B=4 T={T} p0=256",
                                 4, T, 8192, 16, FALCON_RING, 4, bf16,
                                 p0=[256, 256, 256, 0], rows=[1, 2, 3, -1]))
    bwd = phase_kernels_bwd(rng)
    bwd["flash_attention_bwd"] += rag["flash_attention_bwd"]
    timing_floor()
    for r in (att + ver + gat + fl + ss + rr + br + sv
              + bwd["flash_attention_bwd"] + bwd["ssm_scan_bwd"]):
        lib = r["library_ms"]
        log(f"  {r['case']:32s} err={r['max_abs_err']:.2e} "
            + (f"({r['err_share']:.2f} of bound) "
               if "err_share" in r else "") +
            f"ms={r['ms']:.4f} bound={r['bound_ms']:.4f} "
            f"({r['bound_by']}) plain={r['plain_ms']:.4f} "
            f"lib={'null' if lib is None else f'{lib:.4f}'}"
            + (f" boundary={r['boundary_cases']}"
               if "boundary_cases" in r else "")
            + (f" splits={r['splits']}" if "splits" in r else "")
            + (f" live_rows={r['live_rows']}" if "live_rows" in r else "")
            + (f" glue={r['glue_ms']:.4f}" if "glue_ms" in r else ""))
    log_bwd_rows(bwd["flash_attention_bwd"])
    log_scan_bwd_rows(bwd["ssm_scan_bwd"])
    return {"paged_attention": att, "verify_accept_batched": ver,
            "paged_gather": gat, "flash_attention": fl, "ssm_scan": ss,
            "ssm_scan_ring": rr, "branch_decode_attention": br,
            "verify_accept": sv, **bwd}


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

class VerifyShadow:
    """While active, every kernel-route ``device_loop.branch_verify`` call
    is computed a second time by the plain route (``kernel=False``:
    probabilities through ``sampling.verify_chain_device``, no kernel) on
    the same inputs.  The packets must agree: the branch-stage columns
    exactly, the chain verdict except where a uniform lies within
    BOUNDARY_EPS of the boundary that decides it (the accept ratio at the
    first position the routes disagree on, or a residual cdf entry between
    the two tokens), recomputed in f64 from the kernel's own inputs.  Such
    cases are counted.  The plain route launches no counted kernel."""

    def __init__(self):
        self.calls = self.rows = self.positions = self.boundary = 0
        self._bv, self._cv = DL.branch_verify, DL._chain_via_kernel
        self._sv = DL.sps_verify
        self._inputs = None

    def __enter__(self):
        DL.branch_verify, DL._chain_via_kernel = self._verify, self._chain
        DL.sps_verify = self._sps
        return self

    def __exit__(self, *exc):
        DL.branch_verify, DL._chain_via_kernel = self._bv, self._cv
        DL.sps_verify = self._sv

    def _chain(self, *a):
        self._inputs = a
        return self._cv(*a)

    def _verify(self, *a, **kw):
        return self._shadow(self._bv, "branch stage", *a, **kw)

    def _sps(self, *a, **kw):
        # the SpS packet's columns past the chain verdict are the drafted
        # tokens, the same on both routes
        return self._shadow(self._sv, "drafted tokens", *a, **kw)

    def _shadow(self, fn, tail, *a, **kw):
        self._inputs = None
        got = fn(*a, **kw)
        if not kw.get("kernel"):
            return got
        launched = self._inputs is not None    # a chunk reached the kernel
        want = fn(*a, **dict(kw, kernel=False))
        self.calls += launched
        self.rows += got.shape[0] if launched else 0
        self.positions += int(self._inputs[3].sum()) if launched else 0
        if not torch.equal(got[:, 3:], want[:, 3:]):
            raise AssertionError(f"verify shadow: {tail} differs")
        for s in torch.nonzero((got[:, :3] != want[:, :3]).any(1))[:, 0]:
            if not launched or not self._near_boundary(int(s), got[s],
                                                       want[s]):
                raise AssertionError(
                    f"verify shadow: kernel route {got[s].tolist()} != "
                    f"plain route {want[s].tolist()} away from a boundary")
            self.boundary += 1
        return got

    def _near_boundary(self, s, got, want) -> bool:
        p_lg, q_lg, toks, lens, ugrid = self._inputs
        p = torch.softmax(p_lg[s].double(), -1)
        q = torch.softmax(q_lg[s].double(), -1)
        R, L = toks.shape[1], int(lens[s])
        n_g, n_w = int(got[0]), int(want[0])
        if n_g != n_w:                         # an accept test flipped
            j = min(n_g, n_w)
            t = int(toks[s, j])
            ratio = p[j, t] / q[j, t].clamp_min(1e-30)
            return abs(float(ugrid[s, j]) - float(ratio)) <= BOUNDARY_EPS
        pos = min(n_g, R - 1)                  # the residual draw flipped
        r = (p[pos] - q[pos]).clamp_min(0)
        r = r / r.sum() if r.sum() > 1e-12 else p[pos]
        cdf = torch.cumsum(r, 0)
        cdf = cdf / cdf[-1]
        lo, hi = sorted((int(got[1]), int(want[1])))
        near = (cdf[max(lo - 1, 0):hi] - float(ugrid[s, L])).abs().min()
        return float(near) <= BOUNDARY_EPS


def drive(pair, ecfg, prompts, n_new, dev, attn_backend="paged", **kw):
    """One main-path drive with the launch counters zeroed just before and
    read just after."""
    ops.reset_launches()
    res, rep, eng, wall = SV.serve(pair, ecfg, prompts, n_new, device=dev,
                                   attn_backend=attn_backend, **kw)
    counts = dict(ops.LAUNCHES)
    for rid, r in res.items():
        if len(r.tokens) != n_new:
            raise AssertionError(f"request {rid} got {len(r.tokens)} tokens")
    eng.pool.check()
    return res, rep, counts, wall, eng


# the tiny committed pair's batched drives of phases 3 and 11: (name,
# temperature, epsilon, serve options); pools that preempt (SpS splits
# its pages 1:1 between the decoders, SpecBranch 1:7, so SpS needs a
# smaller total)
TINY_N_NEW = 48
TINY_POOL = {"specbranch": 200, "sps": 120}


def tiny_drives(engine: str) -> tuple:
    return (("greedy", 0.0, EPS, {}), ("temp1", 1.0, EPS, {}),
            ("temp1-chains", 1.0, 0.0, {}),
            ("preempt", 0.0, EPS, dict(page_size=4,
                                       pool_pages=TINY_POOL[engine])))


def phase_tiny(dev, totals) -> dict:
    """Phase 3; ``out["served"]`` keeps each SpecBranch drive's results,
    the paged serves phase 11 holds its dense ones against."""
    from repro_torch.training.pairs import get_pair
    pair = get_pair("misaligned", device=dev,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    prompts = SV.make_prompts(4)
    n_new = TINY_N_NEW
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    out = {"served": {}}
    for name, temp, eps, kw in tiny_drives("specbranch"):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                            epsilon=eps, max_len=max_len)
        with VerifyShadow() as sh:
            res, rep, counts, wall, _ = drive(pair, ecfg, prompts, n_new,
                                              dev, **kw)
        out["served"][name] = res
        for k, v in counts.items():
            totals[k] += v
        log(f"  tiny {name}: rounds={rep['rounds']} "
            f"preemptions={rep['preemptions']} wall={wall:.2f}s "
            f"launches={counts}")
        if temp > 0:
            check_shadow(f"tiny {name}", sh, counts, chains=eps == 0.0)
            out[name + " cpu"] = compare_cpu(f"tiny {name}", ecfg, prompts,
                                             n_new, res, cpu_pair())
        if temp == 0.0:
            bad = [i for i in range(len(prompts))
                   if res[i].tokens != greedy[i]]
            if bad:
                raise AssertionError(f"tiny {name}: requests {bad} differ "
                                     "from greedy decoding")
        if counts["paged_attention"] == 0:
            raise AssertionError(f"tiny {name}: paged_attention not run")
        if temp > 0 and counts["verify_accept_batched"] == 0:
            raise AssertionError(f"tiny {name}: verify kernel not launched")
        if name == "preempt" and (rep["preemptions"] == 0
                                  or counts["paged_gather"] == 0):
            raise AssertionError("tiny preempt: no preemption / swap-in "
                                 f"({rep['preemptions']}, {counts})")
        out[name] = dict(rounds=rep["rounds"], preemptions=rep["preemptions"],
                         wall_s=wall, launches=counts)
    return out


def check_shadow(label, sh, counts, chains: bool) -> None:
    """Every verify launch of the drive was shadowed; with the confidence
    stop off (epsilon 0) the chains must also have reached the kernel:
    with the default epsilon the near-flat drafts of these pairs stop at
    their first token, so every chain the kernel sees is empty."""
    log(f"  {label}: verify shadow {sh.calls} calls, {sh.rows} rows, "
        f"{sh.positions} chain positions, {sh.boundary} boundary cases")
    if sh.calls != counts["verify_accept_batched"]:
        raise AssertionError(f"{label}: shadowed calls != verify launches")
    if chains and sh.positions == 0:
        raise AssertionError(f"{label}: no chain position reached the "
                             "verify kernel")


def cpu_pair():
    from repro_torch.training.pairs import get_pair
    return get_pair("misaligned", device="cpu",
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))


def compare_cpu(name, ecfg, prompts, n_new, res, pair, **kw) -> dict:
    """Serve the same drive on the CPU (every kernel's plain version) with
    the same weights and compare the streams.  Printed, not asserted: f32
    logits of the card and the CPU differ in the last bits, which can flip
    a draw that lands near a cdf boundary (or an H-RAD signal whose MLP
    logits lie within that noise of each other); the kernel route itself
    is held exactly by VerifyShadow."""
    cres, _, _, wall = SV.serve(pair, ecfg, prompts, n_new, device="cpu",
                                **kw)
    first = {}
    for i in range(len(prompts)):
        a, b = res[i].tokens, cres[i].tokens
        first[i] = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                        None if len(a) == len(b) else min(len(a), len(b)))
    same = sum(v is None for v in first.values())
    stats = sum(res[i].stats == cres[i].stats for i in range(len(prompts)))
    sig = sum(res[i].stats.hrad_signals == cres[i].stats.hrad_signals
              for i in range(len(prompts)))
    log(f"  {name} vs the same serve on the CPU ({wall:.1f}s): "
        f"{same}/{len(prompts)} streams equal, {stats} GenStats equal, "
        f"{sig} H-RAD signal sequences equal, first divergence by request "
        f"{first}")
    return dict(streams_equal=same, stats_equal=stats, signals_equal=sig,
                first_divergence=first)


def teacher_forced(tp, tcfg, prompts, res, n_new, *, greedy=None,
                   embeds=None, served=None) -> dict:
    """Teacher-forced check of a greedy serve: one cache-less target
    forward per request (B = 1) over its prompt plus its served tokens,
    ``embeds[i]`` (stub embeddings) first where given, its logits read
    only where a token was served.  Every served token must be the argmax
    there, or within TF_MARGIN of the top logit.  Noise yardstick: the
    largest change of those logits when every request runs in one batch
    (other shapes, other reduction order).  ``greedy`` (per request, the
    AR greedy decode): also reads the first position where the served
    stream leaves it and the top-2 gap there.  ``served`` (a
    ``ServedLogits``' records): the serve's own target logits must lie
    within TF_MARGIN of the cache-less forward's at every recorded
    position whose input tokens are the stream's."""
    dev = tp["embed"].device
    P = len(prompts[0])
    if any(len(p) != P for p in prompts):
        raise AssertionError("teacher forcing expects equal prompt lengths")
    off = 0 if embeds is None else embeds[0].shape[1]

    def served_logits(idx):
        seqs = torch.tensor([list(prompts[i]) + res[i].tokens for i in idx],
                            device=dev)
        emb = None if embeds is None else torch.cat([embeds[i] for i in idx])
        lg, _ = M.forward(tp, tcfg, seqs, embeds=emb)
        return lg[:, off + P - 1:off + P - 1 + n_new].float()

    argmax = tokens = n_cmp = 0
    max_gap, err, top2, first = 0.0, 0.0, [], []
    with torch.no_grad():
        one = []
        for i in range(len(prompts)):
            pred = served_logits([i])[0]
            if not bool(torch.isfinite(pred).all()):
                raise AssertionError("teacher forcing: non-finite logits")
            toks = torch.tensor(res[i].tokens, device=dev)
            gap = pred.max(-1).values - pred.gather(-1, toks[:, None])[:, 0]
            t2 = pred.topk(2, -1).values
            top2.append((t2[:, 0] - t2[:, 1]).cpu().tolist())
            argmax += int((gap == 0).sum())
            tokens += int(gap.numel())
            max_gap = max(max_gap, float(gap.max()))
            if greedy is not None:
                j = next((j for j, (a, b) in enumerate(zip(res[i].tokens,
                                                           greedy[i]))
                          if a != b), None)
                first.append(None if j is None
                             else (j, round(top2[i][j], 5)))
            if served is not None:
                stream = list(prompts[i]) + res[i].tokens
                for q, (p0, fed, lg) in served.logits[i].items():
                    if q - P + 1 < n_new and stream[p0:q + 1] == list(fed):
                        err = max(err, float((lg - pred[q - P + 1]).abs()
                                             .max()))
                        n_cmp += 1
            one.append(pred)
        noise = float((served_logits(range(len(prompts)))
                       - torch.stack(one)).abs().max())
        del one
    out = dict(argmax=argmax, tokens=tokens, max_gap=max_gap, noise=noise,
               margin=TF_MARGIN, min_top2=min(min(t) for t in top2))
    log(f"  teacher-forced: {argmax}/{tokens} served tokens are the "
        f"argmax, max gap to the top logit {max_gap:.5f} (margin "
        f"{TF_MARGIN}), noise yardstick {noise:.5f}, smallest top-2 gap "
        f"{out['min_top2']:.5f}")
    if greedy is not None:
        out["first_divergence"] = first
        log(f"  first divergence from AR and top-2 gap there by request: "
            f"{first}")
    if not max_gap <= TF_MARGIN:
        raise AssertionError(f"a served token lies {max_gap} below the top "
                             "logit")
    if served is not None:
        out.update(served_positions=n_cmp, served_max_err=err)
        log(f"  the serve's own target logits at {n_cmp} positions vs the "
            f"cache-less forward's: max abs difference {err:.5f} (margin "
            f"{TF_MARGIN})")
        if n_cmp == 0 or not err <= TF_MARGIN:
            raise AssertionError(f"served logits: {n_cmp} positions, max "
                                 f"difference {err}")
    out["top2"] = top2
    return out


class ServedLogits:
    """While active, records the target logits of a batched engine's own
    forwards (either backend) with the tokens they were fed: the
    prefill's at each prompt's last position and every later target
    forward's at positions P - 1 on, where P is the prompts' length.
    ``logits[i][q] = (start, tokens fed from start through q, logits
    (V,) f32)`` for request i (its index in ``prompts``); the newest
    record at a position wins.  ``teacher_forced(served=)`` holds them
    against the cache-less forward."""

    def __init__(self, prompts, tcfg):
        self.P, self.tcfg = len(prompts[0]), tcfg
        self.index = {tuple(p): i for i, p in enumerate(prompts)}
        self.logits = {i: {} for i in range(len(prompts))}
        self._batched = BE.BatchedEngineBase._batched
        self._prefill = BE.BatchedDecoder.prefill_rows

    def __enter__(self):
        rec = self

        def prefill(dec, parts):
            out = rec._prefill(dec, parts)
            if dec.cfg == rec.tcfg:
                for lane, (_row, t) in enumerate(parts):
                    i = rec.index.get(tuple(t))
                    if i is not None:
                        rec.logits[i][len(t) - 1] = (
                            0, tuple(t),
                            out[0][lane, len(t) - 1].float().clone())
            return out

        def batched(eng, dec, parts):
            out = rec._batched(eng, dec, parts)
            if dec is eng.tgt_dec:
                by_row = {s.tgt.row: s for s in eng.active}
                for row, t, p0 in parts:
                    i = rec.index.get(tuple(by_row[row].prompt))
                    for j in range(len(t)):
                        if i is not None and p0 + j >= rec.P - 1:
                            rec.logits[i][p0 + j] = (
                                p0, tuple(t[:j + 1]),
                                out[0][row, j].float().clone())
            return out
        BE.BatchedEngineBase._batched = batched
        BE.BatchedDecoder.prefill_rows = prefill
        return self

    def __exit__(self, *exc):
        BE.BatchedEngineBase._batched = self._batched
        BE.BatchedDecoder.prefill_rows = self._prefill


def device_events(prof):
    """A finished profiler's CUDA events, the ns of the union of their
    intervals, and their device ns by name (60 characters)."""
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy, end, by_name = 0, None, {}
    for s, e in sorted((e.start_ns(), e.end_ns()) for e in evs):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    for e in evs:
        by_name[e.name()[:60]] = by_name.get(e.name()[:60], 0) \
            + e.duration_ns()
    return evs, busy, by_name


def busy_profile(run) -> dict:
    """Run ``run()`` under the CUDA profiler: the share of the wall window
    in which the card ran a kernel or copy (the union of their intervals
    over the host-clock wall time, profiler overhead included) and the
    device time by kernel name."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    evs, busy, by_name = device_events(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # the attention kernels by their addressing struct (the same names in
    # the parent's tile loops, so an A/B reads both)
    paged = [e.duration_ns() for e in evs if "PagedKeys" in e.name()]
    flash = [e.duration_ns() for e in evs if "DenseKeys" in e.name()]
    # the scan (both entries) and the batched verify, by kernel name (the
    # same names in the parent's kernels)
    scan = [e.duration_ns() for e in evs if "ssm_scan_kernel" in e.name()]
    verify = [e.duration_ns() for e in evs
              if "verify_accept_batched_kernel" in e.name()]
    # the decode loop's ragged path (its instances end in ", true>")
    ragged = [e.duration_ns() for e in evs if "Keys, true>" in e.name()]
    return dict(wall_s=wall, busy_share=busy / 1e9 / wall,
                device_s=sum(by_name.values()) / 1e9,
                ragged_ms=sum(ragged) / 1e6, ragged_launches=len(ragged),
                top=[(n, t / 1e9) for n, t in top],
                paged_ms=sum(paged) / 1e6, paged_launches=len(paged),
                flash_ms=sum(flash) / 1e6, flash_launches=len(flash),
                scan_ms=sum(scan) / 1e6, scan_launches=len(scan),
                verify_ms=sum(verify) / 1e6, verify_launches=len(verify))


def ring_glue_profile(run, ring_shapes) -> dict:
    """Run ``run()`` under the profiler with CPU ops and their input
    shapes: by kernel name, the device time and launches of the kernels
    that PyTorch ops launch on a checkpoint ring (an op whose first
    input has one of ``ring_shapes``, one layer's h_ring): the gather of
    the initial state and the index_put of the checkpoints that the ring
    entry of the scan replaced."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    shapes = {tuple(x) for x in ring_shapes}
    by_kernel = {}
    for ev in prof.events():
        ins = getattr(ev, "input_shapes", None) or []
        if not ins or tuple(ins[0]) not in shapes:
            continue
        for k in getattr(ev, "kernels", []):
            name = f"{ev.name}: {k.name[:50]}"
            ms, n = by_kernel.get(name, (0.0, 0))
            by_kernel[name] = (ms + k.duration / 1e3, n + 1)
    return dict(ms=sum(v[0] for v in by_kernel.values()),
                launches=sum(v[1] for v in by_kernel.values()),
                by_kernel=by_kernel)


def ring_shapes(eng) -> list:
    """One layer's h_ring shape in each of an engine's decoders."""
    return sorted({tuple(c["h_ring"].shape[1:])
                   for dec in (eng.tgt_dec, eng.dft_dec)
                   for c in M.iter_slots(dec.cache) if "h_ring" in c})


def log_ring(prof, glue) -> None:
    log(f"    ssm_scan kernels: {prof['scan_ms']:.2f} ms device time over "
        f"{prof['scan_launches']} launches; PyTorch kernels on the h "
        f"rings: {glue['ms']:.2f} ms over {glue['launches']} launches; "
        f"scan + ring {prof['scan_ms'] + glue['ms']:.2f} ms")
    for name, (ms, n) in sorted(glue["by_kernel"].items(),
                                key=lambda kv: -kv[1][0]):
        log(f"      {ms:8.3f} ms {n:5d}x  {name}")


class RingCensus:
    """While active, counts the ring scan's calls by (lanes, T, E, ring
    depth, ring rows)."""

    def __enter__(self):
        from collections import Counter
        self.shapes = Counter()
        self._orig = ops.ssm_scan_ring

        def spy(x, dt, Bm, Cm, A, D, h_ring, p0, rows=None):
            self.shapes[tuple(x.shape) + (h_ring.shape[1],
                                          h_ring.shape[0])] += 1
            return self._orig(x, dt, Bm, Cm, A, D, h_ring, p0, rows)
        ops.ssm_scan_ring = spy
        return self

    def __exit__(self, *exc):
        ops.ssm_scan_ring = self._orig
        return False


def log_paged(prof) -> None:
    log(f"    paged_attention kernel: {prof['paged_ms']:.2f} ms device time "
        f"over {prof['paged_launches']} launches")


def log_flash(prof) -> None:
    log(f"    flash_attention kernel: {prof['flash_ms']:.2f} ms device time "
        f"over {prof['flash_launches']} launches")


def phase_profile(dev) -> dict:
    """``--profile``: phase 4's profiled greedy serve (full-width
    LLaMA-68M/7B, 8 requests x 8 new tokens), phase 6's profiled
    sequential SpecBranch serve (2 requests x 8 new tokens), the batched
    LLaMA serve at temperature 1 (the verify kernel's device time) and
    phase 8's falcon-mamba-7b batched greedy serve (the scan kernels'
    device time and the PyTorch kernels on its checkpoint rings), each
    after one unprofiled serve, twice; with ``--src`` against another
    checkout's port."""
    pair = SV.load_pair("paper-llama", dev)
    prompts = SV.make_prompts(8)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                        max_len=SV.auto_max_len(prompts, 32, 4, 10.0))
    SV.serve(pair, ecfg, prompts, 8, device=dev)
    out = []
    for _ in range(2):
        prof = busy_profile(lambda: SV.serve(pair, ecfg, prompts, 8,
                                             device=dev))
        log(f"  profile: card busy {prof['busy_share']:.3f} of "
            f"{prof['wall_s']:.2f}s wall, device {prof['device_s']:.4f}s")
        log_paged(prof)
        out.append(prof)
    # the sequential serve runs flash on every attention call (dense ring)
    sprompts = SV.make_prompts(2)
    secfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                         max_len=SV.auto_max_len(sprompts, 32, 4, 10.0))

    def seq():
        done, _, wall = SV.serve_sequential(pair, secfg, "specbranch",
                                            sprompts, 8)
        toks = sum(len(r.result.tokens) for r in done)
        log(f"  seq serve: {toks} tokens, {toks / wall:.2f} wall tokens/s")
    seq()
    for _ in range(2):
        prof = busy_profile(seq)
        log(f"  seq profile: card busy {prof['busy_share']:.3f} of "
            f"{prof['wall_s']:.2f}s wall, device {prof['device_s']:.4f}s")
        log_flash(prof)
        out.append(prof)
    # the paged kernel at the serve's shapes (tables as wide as its
    # longest request), with its inputs in L2 as a forward leaves them,
    # and after the default dirty flush
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    for label, case in (
            ("7B B=8 T=1", (8, 1, 32, 32, 128)),
            ("7B B=8 T=5", (8, 5, 32, 32, 128)),
            ("68M B=8 T=1", (8, 1, 12, 12, 64))):
        args = attn_case(rng, *case, 16, bf, n_max=32)
        t = {f: time_ms(lambda: PA.paged_attention(*args), flush=f)
             for f in ("none", "dirty")}
        log(f"  paged {label} 32-page table: {t['none']:.4f} ms warm, "
            f"{t['dirty']:.4f} ms after the dirty flush")
    # flash at the sequential serve's shapes: a 512-slot ring early in a
    # request, the 7B verify chunk, the fork and the 68M draft tick
    for label, case in (
            ("7B B=1 T=5 S=512 L=40", (1, 5, 512, 32, 32, 128, 40)),
            ("7B B=6 T=1 S=512 L=41", (6, 1, 512, 32, 32, 128, 41)),
            ("68M B=1 T=1 S=512 L=40", (1, 1, 512, 12, 12, 64, 40))):
        args = flash_case(rng, *case, bf)
        t = {f: time_ms(lambda: FA.flash_attention(*args), flush=f)
             for f in ("none", "dirty")}
        log(f"  flash {label}: {t['none']:.4f} ms warm, "
            f"{t['dirty']:.4f} ms after the dirty flush")
    # the batched LLaMA serve at temperature 1 (epsilon 0, so that the
    # drafted chains reach the verify kernel)
    tecfg = EngineConfig(gamma=4, c=10.0, temperature=1.0, epsilon=0.0,
                         max_len=SV.auto_max_len(prompts, 32, 4, 10.0))
    SV.serve(pair, tecfg, prompts, 8, device=dev)
    for _ in range(2):
        prof = busy_profile(lambda: SV.serve(pair, tecfg, prompts, 8,
                                             device=dev))
        log(f"  temp1 profile: card busy {prof['busy_share']:.3f} of "
            f"{prof['wall_s']:.2f}s wall, device {prof['device_s']:.4f}s")
        log(f"    verify_accept_batched kernel: {prof['verify_ms']:.2f} ms "
            f"device time over {prof['verify_launches']} launches")
        out.append(prof)
    # the falcon-mamba-7b batched greedy serve: the scan and the PyTorch
    # kernels on its checkpoint rings
    del pair
    free_device_memory()
    fpair = SV.load_pair("falcon-mamba-7b", dev)
    fecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                         max_len=SV.auto_max_len(prompts, 32, 4, 10.0))
    _res, _rep, eng, _wall = SV.serve(fpair, fecfg, prompts, 8, device=dev)
    shapes = ring_shapes(eng)
    del eng
    free_device_memory()
    for _ in range(2):
        prof = busy_profile(lambda: SV.serve(fpair, fecfg, prompts, 8,
                                             device=dev))
        glue = ring_glue_profile(lambda: SV.serve(fpair, fecfg, prompts, 8,
                                                  device=dev), shapes)
        log(f"  falcon profile: card busy {prof['busy_share']:.3f} of "
            f"{prof['wall_s']:.2f}s wall, device {prof['device_s']:.4f}s")
        log_ring(prof, glue)
        out.append(dict(prof, ring=glue))
    return out


def phase_full(dev, totals, pair) -> dict:
    prompts = SV.make_prompts(8)
    n_new = FULL_NEW
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    with torch.no_grad():
        lg, _ = M.forward(pair[2], pair[3],
                          torch.tensor(prompts, device=dev))
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("full width: non-finite target logits")
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    out = {}
    for name, temp, eps in (("greedy", 0.0, EPS), ("temp1", 1.0, EPS),
                            ("temp1-chains", 1.0, 0.0)):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                            epsilon=eps, max_len=max_len)
        torch.cuda.reset_peak_memory_stats()
        with VerifyShadow() as sh:
            res, rep, counts, wall, _ = drive(pair, ecfg, prompts, n_new,
                                              dev)
        peak = torch.cuda.max_memory_allocated() / 1e9
        for k, v in counts.items():
            totals[k] += v
        toks = sum(len(r.tokens) for r in res.values())
        agree = sum(a == b for i in range(len(prompts))
                    for a, b in zip(res[i].tokens, greedy[i]))
        mean_acc = float(np.mean([r.stats.mean_accepted
                                  for r in res.values()]))
        log(f"  full {name}: {toks / wall:.1f} tok/s wall, "
            f"rounds={rep['rounds']}, mean accepted={mean_acc:.2f}, "
            f"greedy agreement={agree}/{toks}, peak allocated "
            f"{peak:.2f} GB, launches={counts}")
        if counts["paged_attention"] == 0:
            raise AssertionError(f"full {name}: paged_attention not run")
        if temp > 0 and counts["verify_accept_batched"] == 0:
            raise AssertionError(f"full {name}: verify kernel not launched")
        out[name] = dict(tokens_per_s=toks / wall, wall_s=wall,
                         rounds=rep["rounds"], mean_accepted=mean_acc,
                         greedy_agreement=agree, tokens=toks,
                         launches=counts, peak_gb=peak)
        if temp == 0.0:
            out["teacher_forced"] = teacher_forced(pair[2], pair[3], prompts,
                                                   res, n_new, greedy=greedy)
        else:
            check_shadow(f"full {name}", sh, counts, chains=eps == 0.0)
    # where the time goes: one profiled greedy serve (8 new tokens)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    prof = busy_profile(lambda: SV.serve(pair, ecfg, prompts, 8,
                                         device=dev))
    log(f"  full profile: card busy {prof['busy_share']:.3f} of "
        f"{prof['wall_s']:.2f}s wall; device time by kernel:")
    for n, t in prof["top"]:
        log(f"    {t * 1e3:9.2f} ms  {n}")
    log_paged(prof)
    out["profile"] = prof
    return out


# ---------------------------------------------------------------------------
# phases 5-6: the sequential engines
# ---------------------------------------------------------------------------

SEQ_ENGINES = ["autoregressive", "sps", "adaedl", "confidence-sd",
               "lookahead", "pearl", "specbranch"]
# engines the CLI does not list, served by their class
UNLISTED = {"confidence-sd": TE.ConfidenceSDEngine}


def seq_drive(pair, ecfg, engine, prompts, n_new, totals=None,
              need=("flash_attention",), hrad_params=None,
              draft_heads=None):
    """One sequential main-path drive through ``serve.serve_sequential``
    (the confidence-SD baseline, which the CLI does not list, by its class)
    with the launch counters zeroed just before and read just after; each
    kernel in ``need`` must have launched."""
    ops.reset_launches()
    done, _, wall = SV.serve_sequential(
        pair, ecfg, UNLISTED.get(engine, engine), prompts, n_new,
        hrad_params=hrad_params, draft_heads=draft_heads)
    counts = dict(ops.LAUNCHES)
    if totals is not None:
        for k, v in counts.items():
            totals[k] += v
    res = {r.rid: r.result for r in done}
    for rid, r in res.items():
        if len(r.tokens) != n_new:
            raise AssertionError(f"{engine} request {rid} got "
                                 f"{len(r.tokens)} tokens")
    for k in need:
        if counts[k] == 0:
            raise AssertionError(f"{engine}: {k} not run")
    return res, counts, wall


def phase_seq_tiny(dev, totals) -> dict:
    from repro_torch.training.pairs import get_pair
    cache_dir = os.path.join(ROOT, ".cache", "pairs")
    pair = get_pair("misaligned", device=dev, cache_dir=cache_dir)
    prompts = SV.make_prompts(2)
    n_new = 32
    greedy = [RN.greedy_reference(pair[2], pair[3], p, n_new, max_len=512)
              for p in prompts]
    out = {}
    for name in SEQ_ENGINES:
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=512)
        res, counts, wall = seq_drive(pair, ecfg, name, prompts, n_new,
                                      totals)
        bad = [i for i in range(len(prompts)) if res[i].tokens != greedy[i]]
        log(f"  seq tiny {name} greedy: wall={wall:.2f}s "
            f"launches={counts['flash_attention']}")
        if bad:
            raise AssertionError(f"seq tiny {name}: requests {bad} differ "
                                 "from the AR greedy decode")
        out[name] = dict(wall_s=wall, launches=counts)
    cpu = get_pair("misaligned", device="cpu", cache_dir=cache_dir)
    for name in ("sps", "specbranch"):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=1.0, max_len=512)
        res, counts, wall = seq_drive(pair, ecfg, name, prompts, n_new,
                                      totals)
        cres, _, cwall = SV.serve_sequential(cpu, ecfg, name, prompts,
                                             n_new)
        first = {}
        for r in cres:
            a, b = res[r.rid].tokens, r.result.tokens
            first[r.rid] = next((j for j, (x, y) in enumerate(zip(a, b))
                                 if x != y), None)
        same = sum(v is None for v in first.values())
        stats = sum(res[r.rid].stats == r.result.stats for r in cres)
        log(f"  seq tiny {name} temp1 vs the same serve on the CPU "
            f"({cwall:.1f}s): {same}/{len(prompts)} streams equal, {stats} "
            f"GenStats equal, first divergence by request {first}")
        out[name + " temp1"] = dict(wall_s=wall, launches=counts,
                                    streams_equal=same, stats_equal=stats)
    return out


def phase_seq_full(dev, totals, pair) -> dict:
    prompts = SV.make_prompts(2)
    n_new = FULL_NEW
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = [RN.greedy_reference(pair[2], pair[3], p, n_new,
                                  max_len=max_len) for p in prompts]
    out = {}
    for name, temp, eps in (("autoregressive", 0.0, EPS),
                            ("sps", 0.0, EPS), ("specbranch", 0.0, EPS),
                            ("specbranch", 1.0, 0.0)):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                            epsilon=eps, max_len=max_len)
        res, counts, wall = seq_drive(pair, ecfg, name, prompts, n_new,
                                      totals)
        toks = sum(len(r.tokens) for r in res.values())
        rounds = sum(len(r.timeline) for r in res.values())
        mean_acc = float(np.mean([r.stats.mean_accepted
                                  for r in res.values()]))
        label = f"{name} t={temp:g}"
        log(f"  seq full {label}: {toks / wall:.1f} tok/s wall, "
            f"rounds={rounds}, mean accepted={mean_acc:.2f}, "
            f"flash launches={counts['flash_attention']}")
        out[label] = dict(tokens_per_s=toks / wall, wall_s=wall,
                          rounds=rounds, mean_accepted=mean_acc,
                          launches=counts)
        if temp == 0.0:
            out[label]["teacher_forced"] = teacher_forced(
                pair[2], pair[3], prompts, res, n_new, greedy=greedy)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    prof = busy_profile(lambda: SV.serve_sequential(pair, ecfg, "specbranch",
                                                    prompts, 8))
    log(f"  seq full profile (specbranch, 8 new tokens): card busy "
        f"{prof['busy_share']:.3f} of {prof['wall_s']:.2f}s wall; device "
        "time by kernel:")
    for n, t in prof["top"]:
        log(f"    {t * 1e3:9.2f} ms  {n}")
    log_flash(prof)
    out["profile"] = prof
    return out


# ---------------------------------------------------------------------------
# phases 7-8: SSM and hybrid serving
# ---------------------------------------------------------------------------

def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


class CountRestores:
    """Counts ring-snapshot restores (``BatchedDecoder.restore``) while
    active."""

    def __init__(self):
        from repro_torch.serving import batched_engine as BE
        self.cls, self.n = BE.BatchedDecoder, 0
        self._orig = self.cls.restore

    def __enter__(self):
        orig = self._orig

        def restore(dec, *a):
            self.n += 1
            return orig(dec, *a)
        self.cls.restore = restore
        return self

    def __exit__(self, *exc):
        self.cls.restore = self._orig


def phase_hybrid(dev, totals) -> dict:
    from repro_torch.training.pairs import HYBRID_KINDS
    prompts = SV.make_prompts(4)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    out = {}
    for kind in HYBRID_KINDS:
        pair = SV.load_pair(kind, dev)
        cpu = tree_to(pair, "cpu")
        attn = kind == "jamba-shaped"
        need = ["ssm_scan_ring"] + (["paged_attention"] if attn else [])
        greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
        drives = [("greedy", 0.0, EPS, {}), ("temp1", 1.0, EPS, {}),
                  ("temp1-chains", 1.0, 0.0, {})]
        if attn:
            drives.append(("preempt", 0.0, EPS,
                           dict(page_size=4, pool_pages=160)))
        for name, temp, eps, kw in drives:
            label = f"{kind} {name}"
            ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                                epsilon=eps, max_len=max_len)
            with VerifyShadow() as sh, CountRestores() as cr:
                res, rep, counts, wall, eng = drive(pair, ecfg, prompts,
                                                    n_new, dev, **kw)
            for k, v in counts.items():
                totals[k] += v
            log(f"  {label}: rounds={rep['rounds']} "
                f"preemptions={rep['preemptions']} ring restores={cr.n} "
                f"wall={wall:.2f}s launches={counts}")
            for k in need + (["verify_accept_batched"] if temp > 0 else []):
                if counts[k] == 0:
                    raise AssertionError(f"{label}: {k} not launched")
            if temp > 0:
                check_shadow(label, sh, counts, chains=eps == 0.0)
                out[label + " cpu"] = compare_cpu(label, ecfg, prompts,
                                                  n_new, res, cpu)
            else:
                bad = [i for i in range(len(prompts))
                       if res[i].tokens != greedy[i]]
                if bad:
                    raise AssertionError(f"{label}: requests {bad} differ "
                                         "from greedy decoding")
            if name == "preempt" and (rep["preemptions"] == 0
                                      or counts["paged_gather"] == 0
                                      or eng.swap is None or cr.n == 0):
                raise AssertionError(f"{label}: no preemption, swap-in or "
                                     "ring restore")
            out[label] = dict(rounds=rep["rounds"], wall_s=wall,
                              preemptions=rep["preemptions"],
                              ring_restores=cr.n, launches=counts)
        sprompts = prompts[:2]
        ar = [RN.greedy_reference(pair[2], pair[3], p, n_new, max_len=512)
              for p in sprompts]
        for engine in ("sps", "specbranch"):
            ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                                max_len=512)
            res, counts, wall = seq_drive(
                pair, ecfg, engine, sprompts, n_new, totals,
                need=["ssm_scan"] + (["flash_attention"] if attn else []))
            bad = [i for i in range(len(sprompts))
                   if res[i].tokens != ar[i]]
            log(f"  {kind} seq {engine} greedy: wall={wall:.2f}s "
                f"launches={counts}")
            if bad:
                raise AssertionError(f"{kind} seq {engine}: requests {bad} "
                                     "differ from the AR greedy decode")
            out[f"{kind} seq {engine}"] = dict(wall_s=wall, launches=counts)
    return out


def free_device_memory() -> None:
    """Drop what earlier phases left: an engine's pools hold its decoders'
    COW listeners (a reference cycle), so an engine, and the weights it
    holds, go only when the cycle collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_falcon(dev, totals) -> dict:
    from repro_torch.configs import falcon_mamba_7b
    free_device_memory()
    base = torch.cuda.memory_allocated()
    pair = SV.load_pair("falcon-mamba-7b", dev)
    tcfg = pair[3]
    if (tcfg.num_layers, tcfg.d_model) != (64, 4096) \
            or tcfg != falcon_mamba_7b.CONFIG:
        raise AssertionError("falcon-mamba-7b is not at full width")
    wbytes = tree_bytes(pair[0]) + tree_bytes(pair[2])
    log(f"  weights: target {tree_bytes(pair[2]) / 1e9:.2f} GB, draft "
        f"{tree_bytes(pair[0]) / 1e9:.3f} GB "
        f"({(torch.cuda.memory_allocated() - base) / 1e9:.2f} GB allocated)")
    prompts = SV.make_prompts(8)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    with torch.no_grad():
        lg, _ = M.forward(pair[2], tcfg, torch.tensor(prompts, device=dev))
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("falcon: non-finite target logits")
    greedy = M.greedy_reference(pair[2], tcfg, prompts, n_new)
    out = {"weights_gb": wbytes / 1e9}
    for name, temp, eps in (("greedy", 0.0, EPS), ("temp1-chains", 1.0, 0.0)):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, epsilon=eps,
                            max_len=max_len)
        torch.cuda.reset_peak_memory_stats()
        with VerifyShadow() as sh, RingCensus() as census:
            res, rep, counts, wall, eng = drive(pair, ecfg, prompts, n_new,
                                                dev)
        peak = torch.cuda.max_memory_allocated()
        rings = tree_bytes(eng.tgt_dec.cache) + tree_bytes(eng.dft_dec.cache)
        shapes = ring_shapes(eng)
        del eng
        free_device_memory()
        for k, v in counts.items():
            totals[k] += v
        toks = sum(len(r.tokens) for r in res.values())
        mean_acc = float(np.mean([r.stats.mean_accepted
                                  for r in res.values()]))
        log(f"  falcon {name}: {toks / wall:.1f} tok/s wall, "
            f"rounds={rep['rounds']}, mean accepted={mean_acc:.2f}, "
            f"ssm_scan_ring launches={counts['ssm_scan_ring']}, "
            f"launches={counts}; rings {rings / 1e9:.2f} GB, peak "
            f"allocated {peak / 1e9:.2f} GB")
        log(f"  falcon {name} ring scans by (lanes, T, E, Rg, rows): "
            f"{dict(census.shapes.most_common())}")
        if counts["ssm_scan_ring"] == 0:
            raise AssertionError(f"falcon {name}: ssm_scan_ring not "
                                 "launched")
        if census.shapes[(8, 16, 8192, FALCON_RING, 8)] == 0:
            raise AssertionError(f"falcon {name}: the serve never ran the "
                                 f"ring scan at phase 2's shape "
                                 f"({FALCON_RING_CASE})")
        out[name] = dict(tokens_per_s=toks / wall, wall_s=wall,
                         rounds=rep["rounds"], mean_accepted=mean_acc,
                         tokens=toks, launches=counts, rings_gb=rings / 1e9,
                         peak_gb=peak / 1e9)
        if temp == 0.0:
            out["teacher_forced"] = teacher_forced(pair[2], tcfg, prompts,
                                                   res, n_new, greedy=greedy)
        else:
            if counts["verify_accept_batched"] == 0:
                raise AssertionError("falcon temp1: verify not launched")
            check_shadow(f"falcon {name}", sh, counts, chains=True)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    prof = busy_profile(lambda: SV.serve(pair, ecfg, prompts, 8,
                                         device=dev))
    log(f"  falcon profile (greedy, 8 new tokens): card busy "
        f"{prof['busy_share']:.3f} of {prof['wall_s']:.2f}s wall; device "
        "time by kernel:")
    for n, t in prof["top"]:
        log(f"    {t * 1e3:9.2f} ms  {n}")
    glue = ring_glue_profile(lambda: SV.serve(pair, ecfg, prompts, 8,
                                              device=dev), shapes)
    log_ring(prof, glue)
    out["profile"] = dict(prof, ring=glue)
    return out


# ---------------------------------------------------------------------------
# phases 9-10: H-RAD hybrid drafting and batched SpS
# ---------------------------------------------------------------------------

def hrad_mlp(tcfg, dev):
    """The untrained H-RAD MLP of phases 9-10, drawn on the CPU under
    HRAD_SEED (so the card and the CPU get the same parameters)."""
    return H.init_mlp((EngineConfig.hrad_k_layers + 1) * tcfg.d_model,
                      generator=torch.Generator().manual_seed(HRAD_SEED),
                      device=dev)


def signal_hist(results) -> list:
    hist = [0, 0, 0]
    for r in results:
        for s in r.stats.hrad_signals:
            hist[s] += 1
    return hist


def phase_hrad_tiny(dev, totals) -> dict:
    from repro_torch.training.pairs import get_pair
    pair = get_pair("misaligned", device=dev,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    cpu = cpu_pair()
    hp, hp_cpu = hrad_mlp(pair[3], dev), hrad_mlp(cpu[3], "cpu")
    prompts = SV.make_prompts(4)
    n_new = 48
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    hist = [0, 0, 0]
    out = {}
    for name, engine, temp, kw in (
            ("sps greedy", "sps", 0.0, {}),
            ("sps temp1", "sps", 1.0, {}),
            ("hrad greedy", "specbranch", 0.0, {}),
            ("hrad preempt", "specbranch", 0.0,
             dict(page_size=4, pool_pages=200)),
            ("hrad temp1", "specbranch", 1.0, {})):
        label = f"tiny {name}"
        hrad = engine == "specbranch"
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, max_len=max_len)
        with VerifyShadow() as sh:
            res, rep, counts, wall, _ = drive(
                pair, ecfg, prompts, n_new, dev, engine=engine,
                hrad_params=hp if hrad else None, **kw)
        for k, v in counts.items():
            totals[k] += v
        h = signal_hist(res.values())
        hist = [a + b for a, b in zip(hist, h)]
        log(f"  {label}: rounds={rep['rounds']} "
            f"preemptions={rep['preemptions']} s_t histogram={h} "
            f"wall={wall:.2f}s launches={counts}")
        if counts["paged_attention"] == 0:
            raise AssertionError(f"{label}: paged_attention not run")
        if temp > 0:
            if counts["verify_accept_batched"] == 0:
                raise AssertionError(f"{label}: verify kernel not launched")
            # SpS drafts gamma tokens every round: its chains always reach
            # the kernel
            check_shadow(label, sh, counts, chains=engine == "sps")
            out[name + " cpu"] = compare_cpu(
                label, ecfg, prompts, n_new, res, cpu, engine=engine,
                hrad_params=hp_cpu if hrad else None)
        else:
            bad = [i for i in range(len(prompts))
                   if res[i].tokens != greedy[i]]
            if bad:
                raise AssertionError(f"{label}: requests {bad} differ from "
                                     "greedy decoding")
        if name == "hrad preempt" and (rep["preemptions"] == 0
                                       or counts["paged_gather"] == 0):
            raise AssertionError(f"{label}: no preemption / swap-in")
        out[name] = dict(rounds=rep["rounds"], preemptions=rep["preemptions"],
                         signals=h, wall_s=wall, launches=counts)
    sprompts = prompts[:2]
    ar = [RN.greedy_reference(pair[2], pair[3], p, 32, max_len=512)
          for p in sprompts]
    for temp in (0.0, 1.0):
        label = f"tiny seq hrad t={temp:g}"
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, max_len=512)
        res, counts, wall = seq_drive(pair, ecfg, "specbranch", sprompts,
                                      32, totals, hrad_params=hp)
        h = signal_hist(res.values())
        hist = [a + b for a, b in zip(hist, h)]
        log(f"  {label}: s_t histogram={h} wall={wall:.2f}s "
            f"flash launches={counts['flash_attention']}")
        if temp == 0.0:
            bad = [i for i in range(len(sprompts))
                   if res[i].tokens != ar[i]]
            if bad:
                raise AssertionError(f"{label}: requests {bad} differ from "
                                     "the AR greedy decode")
        else:
            cres, _, _ = SV.serve_sequential(cpu, ecfg, "specbranch",
                                             sprompts, 32,
                                             hrad_params=hp_cpu)
            same = sum(res[r.rid].tokens == r.result.tokens for r in cres)
            sig = sum(res[r.rid].stats.hrad_signals
                      == r.result.stats.hrad_signals for r in cres)
            log(f"  {label} vs the same serve on the CPU: {same}/"
                f"{len(sprompts)} streams equal, {sig} signal sequences "
                "equal")
        out[label] = dict(signals=h, wall_s=wall, launches=counts)
    log(f"  tiny s_t histogram over phase 9 (all-reject, confidence, "
        f"all-accept): {hist}")
    if min(hist) == 0:
        raise AssertionError(f"tiny H-RAD: a signal class never occurred "
                             f"({hist})")
    out["signals"] = hist
    return out


def phase_hrad_full(dev, totals, pair, without) -> dict:
    """``without``: phase 4's and phase 6's results, the same serves
    without H-RAD, printed beside."""
    prompts = SV.make_prompts(8)
    n_new = FULL_NEW
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    hp = hrad_mlp(pair[3], dev)
    out = {}
    for name, engine, temp, hrad in (("sps greedy", "sps", 0.0, None),
                                     ("sps temp1", "sps", 1.0, None),
                                     ("specbranch+hrad greedy", "specbranch",
                                      0.0, hp)):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                            max_len=max_len)
        torch.cuda.reset_peak_memory_stats()
        with VerifyShadow() as sh:
            res, rep, counts, wall, eng = drive(
                pair, ecfg, prompts, n_new, dev, engine=engine,
                hrad_params=hrad)
        peak = torch.cuda.max_memory_allocated()
        del eng
        free_device_memory()
        for k, v in counts.items():
            totals[k] += v
        toks = sum(len(r.tokens) for r in res.values())
        mean_acc = float(np.mean([r.stats.mean_accepted
                                  for r in res.values()]))
        prof = busy_profile(lambda: SV.serve(
            pair, ecfg, prompts, 8, device=dev, engine=engine,
            hrad_params=hrad))
        h = signal_hist(res.values())
        log(f"  full {name}: {toks / wall:.1f} tok/s wall, "
            f"rounds={rep['rounds']}, mean accepted={mean_acc:.2f}, "
            f"s_t histogram={h}, peak allocated {peak / 1e9:.2f} GB, "
            f"profiled 8-token serve busy {prof['busy_share']:.3f} of "
            f"{prof['wall_s']:.2f}s, launches={counts}")
        log_paged(prof)
        if counts["paged_attention"] == 0:
            raise AssertionError(f"full {name}: paged_attention not run")
        out[name] = dict(tokens_per_s=toks / wall, wall_s=wall,
                         rounds=rep["rounds"], mean_accepted=mean_acc,
                         signals=h, peak_gb=peak / 1e9,
                         busy_share=prof["busy_share"], launches=counts)
        if temp == 0.0:
            out[name]["teacher_forced"] = teacher_forced(
                pair[2], pair[3], prompts, res, n_new, greedy=greedy)
        else:
            if counts["verify_accept_batched"] == 0:
                raise AssertionError(f"full {name}: verify not launched")
            check_shadow(f"full {name}", sh, counts, chains=True)
    sprompts = prompts[:2]
    ar = [RN.greedy_reference(pair[2], pair[3], p, n_new, max_len=max_len)
          for p in sprompts]
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = seq_drive(pair, ecfg, "specbranch", sprompts, n_new,
                                  totals, hrad_params=hp)
    peak = torch.cuda.max_memory_allocated()
    toks = sum(len(r.tokens) for r in res.values())
    rounds = sum(len(r.timeline) for r in res.values())
    mean_acc = float(np.mean([r.stats.mean_accepted for r in res.values()]))
    prof = busy_profile(lambda: SV.serve_sequential(
        pair, ecfg, "specbranch", sprompts, 8, hrad_params=hp))
    h = signal_hist(res.values())
    log(f"  full seq specbranch+hrad greedy: {toks / wall:.1f} tok/s wall, "
        f"rounds={rounds}, mean accepted={mean_acc:.2f}, s_t histogram={h}, "
        f"peak allocated {peak / 1e9:.2f} GB, profiled 8-token serve busy "
        f"{prof['busy_share']:.3f} of {prof['wall_s']:.2f}s")
    out["seq specbranch+hrad greedy"] = dict(
        tokens_per_s=toks / wall, wall_s=wall, rounds=rounds,
        mean_accepted=mean_acc, signals=h, peak_gb=peak / 1e9,
        busy_share=prof["busy_share"], launches=counts,
        teacher_forced=teacher_forced(pair[2], pair[3], sprompts, res, n_new,
                                      greedy=ar))
    b, q = without["batched"]["greedy"], without["seq"]["specbranch t=0"]
    log(f"  without H-RAD in this run (not a claim): batched specbranch "
        f"greedy {b['tokens_per_s']:.1f} tok/s, {b['rounds']} rounds "
        f"(phase 4); sequential specbranch greedy {q['tokens_per_s']:.1f} "
        f"tok/s, {q['rounds']} rounds (phase 6)")
    return out


# ---------------------------------------------------------------------------
# phases 11-12: the dense backend and the trace recorder
# ---------------------------------------------------------------------------

def first_diff(a, b) -> dict:
    """Per request, the first index where two served streams differ (None
    where they are equal)."""
    return {i: next((j for j, (x, y) in enumerate(zip(a[i].tokens,
                                                      b[i].tokens))
                     if x != y), None if len(a[i].tokens)
                    == len(b[i].tokens) else 0) for i in a}


def phase_dense_tiny(dev, totals, paged_served=None) -> dict:
    """Batched SpecBranch and SpS on the dense backend, tiny committed
    pair: every drive's streams must equal the card's own paged serve
    (the reference's oracle; for SpecBranch phase 3's drives,
    ``paged_served`` by name, where given: the same serves, themselves
    held against the CPU in phase 3);
    greedy streams the target's greedy decode; temperature-1 verdicts are
    shadowed as in phase 3; the SpecBranch preempting pool must swap and
    read the swap back through the gather kernel.  Then the jamba-shaped
    hybrid on the dense backend, whose preempted rows recompute their
    prefix (a dense hybrid row is not swappable, as in the reference)."""
    from repro_torch.training.pairs import get_pair
    pair = get_pair("misaligned", device=dev,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    prompts = SV.make_prompts(4)
    n_new = TINY_N_NEW
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    out = {}
    for engine in ("specbranch", "sps"):
        for name, temp, eps, kw in tiny_drives(engine):
            label = f"dense tiny {engine} {name}"
            ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                                epsilon=eps, max_len=max_len)
            with VerifyShadow() as sh:
                res, rep, counts, wall, eng = drive(
                    pair, ecfg, prompts, n_new, dev, attn_backend="dense",
                    engine=engine, **kw)
            swap = eng.swap is not None
            del eng
            for k, v in counts.items():
                totals[k] += v
            paged = (paged_served or {}).get(name) if (
                engine == "specbranch") else None
            if paged is None:
                paged = SV.serve(pair, ecfg, prompts, n_new, device=dev,
                                 attn_backend="paged", engine=engine,
                                 **kw)[0]
            d_paged = first_diff(res, paged)
            log(f"  {label}: rounds={rep['rounds']} "
                f"preemptions={rep['preemptions']} wall={wall:.2f}s "
                f"launches={counts}; first difference from the card's "
                f"paged serve {d_paged}")
            if any(v is not None for v in d_paged.values()):
                raise AssertionError(f"{label}: streams differ from the "
                                     "paged serve")
            if temp == 0.0:
                bad = [i for i in range(len(prompts))
                       if res[i].tokens != greedy[i]]
                if bad:
                    raise AssertionError(f"{label}: requests {bad} differ "
                                         "from greedy decoding")
            else:
                check_shadow(label, sh, counts, chains=eps == 0.0)
                if counts["verify_accept_batched"] == 0:
                    raise AssertionError(f"{label}: verify not launched")
            if counts["flash_attention"] == 0 or counts["paged_attention"]:
                raise AssertionError(f"{label}: the dense serve must run "
                                     f"flash and not paged ({counts})")
            if name == "preempt" and (rep["preemptions"] == 0 or not swap
                                      or counts["paged_gather"] == 0):
                raise AssertionError(f"{label}: no preemption / swap-in "
                                     f"({rep['preemptions']}, {counts})")
            out[label] = dict(rounds=rep["rounds"],
                              preemptions=rep["preemptions"], wall_s=wall,
                              launches=counts)
    # the jamba-shaped hybrid on the dense backend, preempting
    jpair = SV.load_pair("jamba-shaped", dev)
    jgreedy = M.greedy_reference(jpair[2], jpair[3], prompts[:2], 32)
    jmax = SV.auto_max_len(prompts, 32, 4, 10.0)
    for name, kw in (("greedy", {}),
                     ("preempt", dict(page_size=4, pool_pages=160))):
        label = f"dense jamba-shaped {name}"
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                            max_len=jmax)
        with CountRestores() as cr:
            res, rep, counts, wall, eng = drive(
                jpair, ecfg, prompts[:2], 32, dev, attn_backend="dense",
                **kw)
        swap = eng.swap is not None
        del eng
        for k, v in counts.items():
            totals[k] += v
        log(f"  {label}: rounds={rep['rounds']} "
            f"preemptions={rep['preemptions']} swap store={swap} "
            f"ring restores={cr.n} wall={wall:.2f}s launches={counts}")
        bad = [i for i in range(2) if res[i].tokens != jgreedy[i]]
        if bad:
            raise AssertionError(f"{label}: requests {bad} differ from "
                                 "greedy decoding")
        for k in ("ssm_scan_ring", "flash_attention"):
            if counts[k] == 0:
                raise AssertionError(f"{label}: {k} not launched")
        if name == "preempt" and (rep["preemptions"] == 0 or swap
                                  or cr.n):
            raise AssertionError(f"{label}: a dense hybrid must preempt by "
                                 "recompute (no swap store, no restore)")
        out[label] = dict(rounds=rep["rounds"], wall_s=wall,
                          preemptions=rep["preemptions"], launches=counts)
    return out


def phase_dense_full(dev, totals, pair, paged_prof) -> dict:
    """The full-width LLaMA-68M/7B pair on the dense backend: batched
    SpecBranch 8 x LATE_NEW greedy, teacher-forced as in phase 4; a profiled
    8-token serve's flash launches and device time beside phase 4's paged
    figures (``paged_prof``); what a SpecBranch fork copies (the draft
    decoder's row, on the dense backend) and what that costs."""
    prompts = SV.make_prompts(8)
    n_new = LATE_NEW
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    torch.cuda.reset_peak_memory_stats()
    res, rep, counts, wall, eng = drive(pair, ecfg, prompts, n_new, dev,
                                        attn_backend="dense")
    peak = torch.cuda.max_memory_allocated()
    for k, v in counts.items():
        totals[k] += v
    toks = sum(len(r.tokens) for r in res.values())
    log(f"  full dense greedy: {toks / wall:.1f} tok/s wall (information "
        f"only), rounds={rep['rounds']}, peak allocated {peak / 1e9:.2f} "
        f"GB, launches={counts}")
    if counts["flash_attention"] == 0 or counts["paged_attention"]:
        raise AssertionError(f"full dense: flash must run and paged not "
                             f"({counts})")
    out = dict(tokens_per_s=toks / wall, wall_s=wall, rounds=rep["rounds"],
               launches=counts, peak_gb=peak / 1e9)
    out["teacher_forced"] = teacher_forced(pair[2], pair[3], prompts, res,
                                           n_new, greedy=greedy)
    # a branch fork on the dense backend copies one draft row (every
    # row-axis leaf); a target row is timed beside it for scale
    for which, dec in (("draft (68M)", eng.dft_dec),
                       ("target (7B)", eng.tgt_dec)):
        nbytes = sum(a[:, 0].numel() * a.element_size()
                     for c in M.iter_slots(dec.cache) for a in c.values())
        ms = time_ms(lambda: dec.copy_row(0, 1))
        bms, _ = bound(2 * nbytes, 0, torch.bfloat16)
        log(f"  dense {which} row copy (a fork's copy_row): "
            f"{nbytes / 1e6:.2f} MB a row, {ms:.4f} ms (bound {bms:.4f})")
        out[f"fork {which}"] = dict(bytes=nbytes, ms=ms, bound_ms=bms)
    del eng
    free_device_memory()
    prof = busy_profile(lambda: SV.serve(pair, ecfg, prompts, 8,
                                         device=dev, attn_backend="dense"))
    log(f"  full dense profile: card busy {prof['busy_share']:.3f} of "
        f"{prof['wall_s']:.2f}s wall, device {prof['device_s']:.4f}s; "
        f"device time by kernel:")
    for n, t in prof["top"]:
        log(f"    {t * 1e3:9.2f} ms  {n}")
    log_flash(prof)
    log(f"    beside phase 4's paged serve: paged_attention "
        f"{paged_prof['paged_ms']:.2f} ms over "
        f"{paged_prof['paged_launches']} launches, device "
        f"{paged_prof['device_s']:.4f}s, busy "
        f"{paged_prof['busy_share']:.3f}")
    if prof["flash_launches"] == 0:
        raise AssertionError("full dense profile: no flash kernel")
    out["profile"] = prof
    return out


def union_ns(iv) -> list:
    """Disjoint union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_in(busy, a: float, b: float) -> float:
    """Seconds of the union ``busy`` (seconds) inside [a, b]."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy)


# marker kernels (``torch.cuda._sleep`` cycles) before and after each
# traced serve of a session: serve i's start markers sleep MARKS[i][0]
# cycles, its end markers MARKS[i][1]; they are told apart by their
# device time, whose class boundaries are MARK_CLASSES_NS (serve i's
# start markers fall in class 2i, its end markers in class 2i + 1)
MARKS = ((1000, 100_000), (300_000, 1_000_000))
MARK_CLASSES_NS = (20_000, 100_000, 300_000, 1_500_000)
SETTLE = 5_000_000      # the session's settling spin: a class of its own


def mark_class(dur_ns: int) -> int:
    return sum(dur_ns >= t for t in MARK_CLASSES_NS)


def round_table(rec, kernels, starts, ends, serve: int = 0) -> dict:
    """The host's share of a round: per span lane (draft, verify, commit)
    and per round, the host wall time of the recorder's spans against the
    device-busy time inside them (the union of the profiler's kernel
    intervals ``kernels``, (name, start ns, end ns)).  The recorder's
    clock is aligned to the profiler's by the marker kernels (names with
    "spin") launched on an idle card right after the recorder readings
    ``starts`` and ``ends``.  The profiler has been seen to miss the
    markers right after it starts (after earlier sessions in the same
    process), so the found start markers match the last readings, the
    found end markers the first, and one side suffices.  Each offset is
    late by one launch latency; the offset is the median of all.  The
    markers are those of the session's ``serve``-th traced serve
    (``MARKS``)."""
    spins = sorted((s, e) for n, s, e in kernels if "spin" in n)
    s_found = [s for s, e in spins if mark_class(e - s) == 2 * serve]
    e_found = [s for s, e in spins if mark_class(e - s) == 2 * serve + 1]
    if not s_found and not e_found:
        raise AssertionError("trace phase: no marker kernel in the trace")
    s_offs = [k / 1e9 - t for k, t in zip(s_found,
                                          starts[len(starts)
                                                 - len(s_found):])]
    e_offs = [k / 1e9 - t for k, t in zip(e_found, ends)]
    off = float(np.median(s_offs + e_offs))
    drift = (float(np.median(e_offs)) - float(np.median(s_offs))
             if s_offs and e_offs else float("nan"))
    marks = [starts[-1], ends[0]]
    busy = [(s / 1e9 - off, e / 1e9 - off) for s, e in
            union_ns((s, e) for n, s, e in kernels if "spin" not in n)]
    spans = [e for e in rec.events if e["kind"] == "span"]
    rounds = [e for e in rec.events if e["kind"] == "round"]
    lanes = {}
    for e in spans:
        n, tw, td = lanes.get(e["lane"], (0, 0.0, 0.0))
        lanes[e["lane"]] = (n + 1, tw + e["wall1"] - e["wall0"],
                            td + busy_in(busy, e["wall0"], e["wall1"]))
    r_wall = sum(r["wall1"] - r["wall0"] for r in rounds)
    r_busy = sum(busy_in(busy, r["wall0"], r["wall1"]) for r in rounds)
    serve = marks[-1] - marks[0]
    all_busy = busy_in(busy, marks[0], marks[-1])
    first = min((s for n, s, e in kernels if "spin" not in n), default=0)
    log(f"  clock alignment: {len(s_found)}/{len(starts)} start and "
        f"{len(e_found)}/{len(ends)} end markers found; offsets "
        f"{[round(o * 1e6, 1) for o in s_offs]} / "
        f"{[round(o * 1e6, 1) for o in e_offs]} us (drift "
        f"{drift * 1e6:.1f} us over the serve); {len(kernels)} kernel "
        f"records, the first "
        f"{(first / 1e9 - off - marks[0]) * 1e3:.2f} ms after the last "
        f"start reading")
    log(f"  host share of a round (CUDA profiler on; {len(rounds)} rounds, "
        f"{len(spans)} spans): lane, spans, host wall ms, device-busy ms "
        f"inside, host share")
    out = {"lanes": {}, "offset_us": off * 1e6, "drift_us": drift * 1e6}
    for lane in ("draft", "verify", "commit"):
        n, tw, td = lanes.get(lane, (0, 0.0, 0.0))
        share = 1.0 - td / tw if tw > 0 else float("nan")
        log(f"    {lane:7s} {n:5d} {tw * 1e3:10.2f} {td * 1e3:10.2f} "
            f"{share:7.3f}")
        out["lanes"][lane] = dict(spans=n, wall_ms=tw * 1e3,
                                  busy_ms=td * 1e3, host_share=share)
    log(f"    rounds  {len(rounds):5d} {r_wall * 1e3:10.2f} "
        f"{r_busy * 1e3:10.2f} {1.0 - r_busy / max(r_wall, 1e-12):7.3f}")
    log(f"    serve (marker to marker) {serve * 1e3:.2f} ms wall, "
        f"{all_busy * 1e3:.2f} ms device-busy; outside rounds (admission, "
        f"prefill, retire) {(serve - r_wall) * 1e3:.2f} ms wall")
    log("    per round: index, mode, batch, draft steps, wall ms, busy ms "
        "(first 6 and last 2)")
    rows = [dict(index=r["index"], mode=r["mode"], batch=r["batch"],
                 draft_steps=r["draft_steps"],
                 wall_ms=(r["wall1"] - r["wall0"]) * 1e3,
                 busy_ms=busy_in(busy, r["wall0"], r["wall1"]) * 1e3)
            for r in rounds]
    for r in rows[:6] + rows[-2:]:
        log(f"      {r['index']:4d} {r['mode']:8s} {r['batch']:2d} "
            f"{r['draft_steps']:3d} {r['wall_ms']:8.2f} {r['busy_ms']:8.2f}")
    out.update(rounds=rows, round_wall_ms=r_wall * 1e3,
               round_busy_ms=r_busy * 1e3, serve_ms=serve * 1e3,
               serve_busy_ms=all_busy * 1e3)
    return out


def phase_trace(dev, totals, pair, modes) -> list:
    """The full-width 7B batched SpecBranch greedy serve on the paged
    backend in each draft mode of ``modes`` ((draft_mode, draft heads)
    pairs), once untraced and once with a TraceRecorder and the loop's
    profiler ranges on, every traced serve inside ONE
    ``obs.profiler_session`` (CUDA activity), each framed by its own
    markers (``MARKS``).  Returns one table per mode.
    Gate: host fetches and host transfer bytes equal with and without the
    trace (and the streams).  Table: per round and per span lane (draft,
    verify, commit), the host wall time against the device-busy time
    inside it, from the profiler's kernel intervals; the recorder's clock
    is aligned to the profiler's by a marker kernel launched on an idle
    card right after a recorder reading, at both ends of the serve."""
    from repro_torch.obs import TraceRecorder, profiler_session
    prompts = SV.make_prompts(8)
    n_new = LATE_NEW
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    runs = []
    for mode, heads in modes:
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                            max_len=max_len, draft_mode=mode)
        res0, rep0, counts0, wall0, eng0 = drive(pair, ecfg, prompts, n_new,
                                                 dev, draft_heads=heads)
        runs.append(dict(mode=mode, heads=heads, ecfg=ecfg, res0=res0,
                         wall0=wall0, fetch0=eng0.host_fetches,
                         bytes0=eng0.host_transfer_bytes))
        del eng0
        for k, v in counts0.items():
            totals[k] += v
        free_device_memory()

    def mark(rec, cycles: int) -> float:
        torch.cuda.synchronize()
        t = rec.now()
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        return t

    # the session's Chrome trace (~200 MB a serve) is written to a
    # scratch directory under build/ and removed once its size is read
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"))
    DL.set_trace_annotations(True)
    try:
        with profiler_session(tmp.name, dev) as prof:
            # settle the freshly started session before the first marker
            torch.cuda._sleep(SETTLE)
            torch.cuda.synchronize()
            time.sleep(0.5)
            for i, r in enumerate(runs):
                rec = r["rec"] = TraceRecorder()
                r["starts"] = [mark(rec, MARKS[i][0]) for _ in range(3)]
                ops.reset_launches()
                r["res1"], r["rep1"], eng1, r["wall1"] = SV.serve(
                    pair, r["ecfg"], prompts, n_new, device=dev,
                    attn_backend="paged", rec=rec, draft_heads=r["heads"])
                r["counts1"] = dict(ops.LAUNCHES)
                r["ends"] = [mark(rec, MARKS[i][1]) for _ in range(3)]
                r["fetch1"] = eng1.host_fetches
                r["bytes1"] = eng1.host_transfer_bytes
                del eng1
    finally:
        DL.set_trace_annotations(False)
    chrome = sum(os.path.getsize(os.path.join(tmp.name, f))
                 for f in os.listdir(tmp.name))
    tmp.cleanup()
    kernels = [(e.name(), e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    log(f"  one profiler session over {len(runs)} traced serve(s): "
        f"{len(kernels)} kernel records, a {chrome / 1e6:.1f} MB Chrome "
        "trace")
    out = []
    for i, r in enumerate(runs):
        for k, v in r["counts1"].items():
            totals[k] += v
        toks = sum(len(x.tokens) for x in r["res1"].values())
        log(f"  {r['mode']} draft mode: untraced serve "
            f"{toks / r['wall0']:.1f} tok/s wall, {r['fetch0']} host "
            f"fetches, {r['bytes0']} bytes; traced and profiled: "
            f"{toks / r['wall1']:.1f} tok/s wall, {r['fetch1']} host "
            f"fetches, {r['bytes1']} bytes, {len(r['rec'].events)} events "
            "(wall figures for information only)")
        if (r["fetch0"], r["bytes0"]) != (r["fetch1"], r["bytes1"]):
            raise AssertionError(
                f"{r['mode']}: the trace changed the host traffic: "
                f"{(r['fetch0'], r['bytes0'])} vs "
                f"{(r['fetch1'], r['bytes1'])}")
        if first_diff(r["res0"], r["res1"]) != {j: None for j in r["res0"]}:
            raise AssertionError(f"{r['mode']}: the traced serve's streams "
                                 "differ")
        if r["counts1"]["paged_attention"] == 0:
            raise AssertionError(f"{r['mode']}: paged_attention not run")
        t = round_table(r["rec"], kernels, r["starts"], r["ends"], serve=i)
        t.update(mode=r["mode"],
                 dispatches_per_round=r["rep1"].get("dispatches_per_round"),
                 tokens_per_s_untraced=toks / r["wall0"],
                 tokens_per_s_traced=toks / r["wall1"],
                 host_fetches=r["fetch1"], host_bytes=r["bytes1"],
                 launches=r["counts1"])
        out.append(t)
    return out


# ---------------------------------------------------------------------------
# phase 13: single-pass parallel drafting and the history predictor
# ---------------------------------------------------------------------------

def draft_heads(cfg, ecfg, dev):
    """The draft heads a parallel-draft serve of ``cfg`` uses: the
    serve CLI's, drawn from ``SV.HEADS_SEED`` on ``dev``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SV.HEADS_SEED)
    return M.init_draft_heads(cfg, SV.heads_k(ecfg), gen, dev)


def check_dispatches(label, rep, eng, want=None) -> float:
    """Dispatches per round from the serve's report; every round tuple of
    a parallel-draft engine must carry its measured count (``want``: the
    count every round must take)."""
    dpr = rep["dispatches_per_round"]
    counted = [r[3] for r in eng.timeline if len(r) > 3]
    if len(counted) != len(eng.timeline):
        raise AssertionError(f"{label}: a round without its dispatches")
    if want is not None and set(counted) != {want}:
        raise AssertionError(f"{label}: dispatches {sorted(set(counted))} "
                             f"!= {want} a round")
    return dpr


def assert_cpu_equal(label, res, cres) -> None:
    """Streams and GenStats of a card drive equal the same serve's on the
    CPU."""
    diff = first_diff(res, cres)
    if any(v is not None for v in diff.values()):
        raise AssertionError(f"{label}: streams differ from the CPU serve "
                             f"(first divergence by request {diff})")
    bad = [i for i in res if res[i].stats != cres[i].stats]
    if bad:
        raise AssertionError(f"{label}: GenStats differ from the CPU serve "
                             f"for requests {bad}")


def phase_parallel_tiny(dev, totals) -> dict:
    """Parallel drafting and the predictor on the tiny committed pair:
    every drive equals the CPU serve and the greedy decode."""
    from repro_torch.training.pairs import get_pair
    cache_dir = os.path.join(ROOT, ".cache", "pairs")
    pair = get_pair("misaligned", device=dev, cache_dir=cache_dir)
    cpu = get_pair("misaligned", device="cpu", cache_dir=cache_dir)
    prompts = SV.make_prompts(4)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    par = EngineConfig(gamma=4, c=10.0, max_len=max_len,
                       draft_mode="parallel")
    heads = draft_heads(pair[1], par, dev)
    cheads = {k: v.cpu() for k, v in heads.items()}
    out = {}
    drives = []
    for engine in ("specbranch", "sps"):
        for backend in ("paged", "dense"):
            for name, temp, eps in (("greedy", 0.0, EPS),
                                    ("temp1", 1.0, EPS),
                                    ("temp1-chains", 1.0, 0.0)):
                if engine == "sps" and name == "temp1-chains":
                    continue        # SpS has no epsilon stop: as temp1
                drives.append((f"{engine} {backend} {name}", engine,
                               backend, temp, eps, "parallel", "off", {}))
    drives.append(("specbranch paged preempt", "specbranch", "paged", 0.0,
                   0.0, "parallel", "off",
                   dict(page_size=4, pool_pages=200)))
    drives.append(("specbranch paged predictor", "specbranch", "paged",
                   1.0, EPS, "sequential", "on", {}))
    drives.append(("specbranch paged parallel predictor", "specbranch",
                   "paged", 1.0, 0.0, "parallel", "on", {}))
    drives.append(("sps dense parallel predictor", "sps", "dense", 0.0,
                   EPS, "parallel", "on", {}))
    for label, engine, backend, temp, eps, mode, pred, kw in drives:
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, epsilon=eps,
                            max_len=max_len, draft_mode=mode,
                            spec_predictor=pred)
        hd = heads if mode == "parallel" else None
        with VerifyShadow() as sh:
            res, rep, counts, wall, eng = drive(
                pair, ecfg, prompts, n_new, dev, attn_backend=backend,
                engine=engine, draft_heads=hd, max_batch=4, **kw)
        for k, v in counts.items():
            totals[k] += v
        cres, _, _, cwall = SV.serve(
            cpu, ecfg, prompts, n_new, device="cpu", attn_backend=backend,
            engine=engine, max_batch=4,
            draft_heads=cheads if hd is not None else None, **kw)
        assert_cpu_equal(f"parallel tiny {label}", res, cres)
        if temp == 0.0:
            bad = [i for i in range(len(prompts))
                   if res[i].tokens != greedy[i]]
            if bad:
                raise AssertionError(f"parallel tiny {label}: requests "
                                     f"{bad} differ from greedy decoding")
        else:
            check_shadow(f"parallel tiny {label}", sh, counts,
                         chains=eps == 0.0)
        kernel = "flash_attention" if backend == "dense" \
            else "paged_attention"
        if counts[kernel] == 0:
            raise AssertionError(f"parallel tiny {label}: {kernel} not run")
        dpr = (check_dispatches(f"parallel tiny {label}", rep, eng,
                                2 if engine == "sps" else None)
               if mode == "parallel" else rep["dispatches_per_round"])
        if kw and (rep["preemptions"] == 0 or counts["paged_gather"] == 0):
            raise AssertionError(f"parallel tiny {label}: no preemption / "
                                 f"swap-in ({rep['preemptions']}, {counts})")
        log(f"  parallel tiny {label}: rounds={rep['rounds']} "
            f"dispatches/round={dpr:.2f} preemptions={rep['preemptions']} "
            f"wall={wall:.2f}s (CPU {cwall:.1f}s), streams and GenStats = "
            f"the CPU serve's, launches={counts}")
        out[label] = dict(rounds=rep["rounds"], dispatches_per_round=dpr,
                          wall_s=wall, launches=counts)
        del eng
    # the sequential engines: parallel drafting, and the predictor
    cprompts = prompts[:2]
    for label, engine, temp, eps, mode, pred in (
            ("seq sps parallel", "sps", 0.0, EPS, "parallel", "off"),
            ("seq sps parallel temp1", "sps", 1.0, EPS, "parallel", "off"),
            ("seq specbranch parallel", "specbranch", 0.0, 0.0, "parallel",
             "off"),
            ("seq specbranch parallel temp1", "specbranch", 1.0, EPS,
             "parallel", "off"),
            ("seq specbranch predictor temp1", "specbranch", 1.0, EPS,
             "sequential", "on")):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, epsilon=eps,
                            max_len=512, draft_mode=mode,
                            spec_predictor=pred)
        hd = heads if mode == "parallel" else None
        res, counts, wall = seq_drive(pair, ecfg, engine, cprompts, n_new,
                                      totals, draft_heads=hd)
        cdone, _, cwall = SV.serve_sequential(
            cpu, ecfg, engine, cprompts, n_new,
            draft_heads=cheads if hd is not None else None)
        assert_cpu_equal(f"parallel tiny {label}", res,
                         {r.rid: r.result for r in cdone})
        if temp == 0.0 and any(res[i].tokens != greedy[i]
                               for i in range(len(cprompts))):
            raise AssertionError(f"parallel tiny {label}: differs from "
                                 "greedy decoding")
        disp = [r[3] for r in res[0].timeline if len(r) > 3]
        log(f"  parallel tiny {label}: wall={wall:.2f}s (CPU "
            f"{cwall:.1f}s), rounds={len(res[0].timeline)}, dispatches "
            f"{sorted(set(disp))}, streams and GenStats = the CPU serve's, "
            f"flash launches={counts['flash_attention']}")
        out[label] = dict(wall_s=wall, launches=counts)
    return out


class FrameLaunches:
    """While active, counts the attention launches inside the batched
    draft decoders' parallel-draft forwards (``step_draft``)."""

    def __init__(self):
        from repro_torch.serving.batched_engine import BatchedDecoder
        self.cls, self.orig = BatchedDecoder, BatchedDecoder.step_draft
        self.frames, self.launches = 0, {}

    def __enter__(self):
        me = self

        def step_draft(dec, *a, **kw):
            n0 = dict(ops.LAUNCHES)
            out = me.orig(dec, *a, **kw)
            me.frames += 1
            for k, v in ops.LAUNCHES.items():
                if v != n0[k]:
                    me.launches[k] = me.launches.get(k, 0) + v - n0[k]
            return out
        self.cls.step_draft = step_draft
        return self

    def __exit__(self, *exc):
        self.cls.step_draft = self.orig


def time_draft_chunk(eng, dev) -> dict:
    """Device time of one ``draft_chunk`` pass at the serve's shapes (the
    draft decoder's rows, the bucketed frame width of a one-token pending
    plus G slots: G = gamma for SpS, max(gamma, gamma_branch) for
    SpecBranch), on random logits and features."""
    n = eng.dft_dec.n_rows
    G = (eng.ecfg.gamma if eng.name == "batched-sps"
         else max(eng.ecfg.gamma, eng.ecfg.gamma_branch))
    T = DL.bucket(2 + G)
    V, D = eng.dcfg.vocab_size, eng.dcfg.d_model
    g = torch.Generator(device=dev).manual_seed(5)
    lg = torch.randn((n, T, V), generator=g, device=dev)
    feats = torch.randn((n, T, D), generator=g, device=dev,
                        dtype=eng.dcfg.tdtype)
    last = np.ones(n, np.int32)
    rids = np.arange(n, dtype=np.int32)
    ctrs = np.zeros(n, np.int32)

    def run():
        return DL.draft_chunk(lg, feats, eng.dp["final_norm"],
                              eng.draft_heads["heads"], last, rids, ctrs,
                              eng._key, g=G, dtemp=eng._dt, stemp=eng._st,
                              eps=eng.dcfg.norm_eps,
                              cap=eng.dcfg.final_softcap)
    # the device time of its kernels from the profiler (a CUDA-event pair
    # would also hold the host's hashing of the uniform grid and its
    # synchronous upload), over ten passes
    for _ in range(3):
        run()
    prof = busy_profile(lambda: [run() for _ in range(10)])
    ms = prof["device_s"] * 1e3 / 10
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(10):
        run()
    torch.cuda.synchronize()
    host_ms = (time.time() - t0) * 1e3 / 10
    # the bytes it must move: logits and features in, the head stack, the
    # q stack and packet out
    nbytes = (lg.numel() * 4 + feats.numel() * feats.element_size()
              + G * D * V * eng.draft_heads["heads"].element_size()
              + (G + 1) * n * V * 4 + n * (G + 1) * 2 * 4)
    bms, by = bound(nbytes, 2 * n * G * D * V, eng.dcfg.tdtype)
    return dict(ms=ms, wall_ms=host_ms, bound_ms=bms, bound_by=by, rows=n,
                width=T, G=G)


def traced_modes_in_child(totals) -> dict:
    """Run ``--trace-modes`` (the 7B SpecBranch serve traced in sequential
    and in parallel draft mode, one profiler session) in a fresh process,
    echo its log, add its launches to ``totals`` and return its tables by
    draft mode.  A fresh process: a later profiler session of one
    process has lost its marker kernels (all of them, once)."""
    path = os.path.join(ROOT, "build", "trace_modes.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--trace-modes", path], capture_output=True,
                          text=True, timeout=900)
    for ln in proc.stdout.splitlines():
        log(f"  | {ln}")
    if proc.returncode != 3:
        raise AssertionError(f"the traced child exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    with open(path) as f:
        got = json.load(f)
    for k, v in got["launches"].items():
        totals[k] += v
    return {t["mode"]: t for t in got["tables"]}


def phase_trace_modes(dev, path) -> None:
    """``--trace-modes PATH``: phase 12's measurement, the sequential and
    the parallel-draft serve in one profiler session; writes the tables
    and the launches to PATH (JSON)."""
    pair = SV.load_pair("paper-llama", dev)
    heads = draft_heads(pair[1], EngineConfig(gamma=4, c=10.0), dev)
    totals = {k: 0 for k in KERNELS}
    tables = phase_trace(dev, totals, pair, modes=(("sequential", None),
                                                   ("parallel", heads)))
    with open(path, "w") as f:
        json.dump({"tables": tables, "launches": totals}, f)


def phase_parallel_full(dev, totals, pair, traced) -> dict:
    """Parallel drafting and the predictor at full width, paged, 8 x LATE_NEW
    greedy; ``traced``: phase 12's host-share tables by draft mode (both
    serves in one profiler session)."""
    prompts = SV.make_prompts(8)
    n_new = LATE_NEW
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    heads = draft_heads(pair[1], EngineConfig(gamma=4, c=10.0), dev)
    out = {}
    for engine in ("specbranch", "sps"):
        for mode in ("sequential", "parallel"):
            label = f"{engine} {mode} draft"
            ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                                max_len=max_len, draft_mode=mode)
            hd = heads if mode == "parallel" else None
            with FrameLaunches() as fr:
                res, rep, counts, wall, eng = drive(
                    pair, ecfg, prompts, n_new, dev, engine=engine,
                    draft_heads=hd)
            for k, v in counts.items():
                totals[k] += v
            toks = sum(len(r.tokens) for r in res.values())
            dpr = (check_dispatches(f"full {label}", rep, eng,
                                    2 if engine == "sps" else None)
                   if mode == "parallel" else rep["dispatches_per_round"])
            log(f"  full {label}: {toks / wall:.1f} tok/s wall, rounds="
                f"{rep['rounds']}, dispatches/round={dpr:.2f}, "
                f"draft frames={fr.frames} with attention launches "
                f"{fr.launches}, launches={counts}")
            tf = teacher_forced(pair[2], pair[3], prompts, res, n_new,
                                greedy=greedy)
            r = dict(tokens_per_s=toks / wall, wall_s=wall,
                     rounds=rep["rounds"], dispatches_per_round=dpr,
                     frames=fr.frames, frame_launches=fr.launches,
                     tf_argmax=tf["argmax"], tf_tokens=tf["tokens"],
                     rollback_per_request=float(np.mean(
                         [r_.stats.rollback_tokens
                          for r_ in res.values()])),
                     launches=counts)
            if mode == "parallel":
                if not fr.frames or not fr.launches.get("paged_attention"):
                    raise AssertionError(f"full {label}: no draft frame "
                                         "ran the paged kernel")
                r["draft_chunk"] = dc = time_draft_chunk(eng, dev)
                log(f"  full {label}: draft_chunk {dc['ms']:.4f} ms of "
                    f"device time a pass ({dc['wall_ms']:.3f} ms of wall "
                    f"with its host work) over {dc['rows']} rows x width "
                    f"{dc['width']}, G={dc['G']} (bound {dc['bound_ms']:.4f}"
                    f", {dc['bound_by']})")
            del eng
            free_device_memory()
            # where the time goes: one profiled serve (8 new tokens)
            prof = busy_profile(lambda: SV.serve(
                pair, ecfg, prompts, 8, device=dev, engine=engine,
                draft_heads=hd))
            log(f"  full {label} profile: card busy "
                f"{prof['busy_share']:.3f} of {prof['wall_s']:.2f}s wall, "
                f"device {prof['device_s']:.4f}s; by kernel:")
            for n, t in prof["top"]:
                log(f"    {t * 1e3:9.2f} ms  {n}")
            log_paged(prof)
            r["profile"] = prof
            out[label] = r
            free_device_memory()
    for engine in ("specbranch", "sps"):
        s, p = out[f"{engine} sequential draft"], \
            out[f"{engine} parallel draft"]
        log(f"  full {engine}: parallel vs sequential draft mode: "
            f"{p['tokens_per_s']:.1f} vs {s['tokens_per_s']:.1f} tok/s wall, "
            f"dispatches/round {p['dispatches_per_round']:.2f} vs "
            f"{s['dispatches_per_round']:.2f}, rounds {p['rounds']} vs "
            f"{s['rounds']}, device "
            f"{p['profile']['device_s']:.4f} vs "
            f"{s['profile']['device_s']:.4f}s a profiled serve")
    # the host's share of a parallel-mode round beside phase 12's
    # sequential-mode one (both serves in phase 12's profiler session)
    del heads
    free_device_memory()
    trace, trace_seq = traced["parallel"], traced["sequential"]
    out["trace"] = trace
    log("  host share, parallel vs sequential draft mode (phase 12's "
        "session): lane, spans, host wall ms, busy ms, host share")
    for lane in ("draft", "verify", "commit"):
        a, b = trace["lanes"][lane], trace_seq["lanes"][lane]
        log(f"    {lane:7s} {a['spans']:4d} {a['wall_ms']:9.2f} "
            f"{a['busy_ms']:8.2f} {a['host_share']:6.3f}   |   "
            f"{b['spans']:4d} {b['wall_ms']:9.2f} {b['busy_ms']:8.2f} "
            f"{b['host_share']:6.3f}")
    for t, name in ((trace, "parallel"), (trace_seq, "sequential")):
        log(f"    rounds ({name}) {len(t['rounds'])} rounds, "
            f"{t['round_wall_ms']:.2f} ms wall, {t['round_busy_ms']:.2f} ms "
            f"busy, host share "
            f"{1.0 - t['round_busy_ms'] / max(t['round_wall_ms'], 1e-9):.3f}"
            f", dispatches/round {t.get('dispatches_per_round')}")
    for t, name in ((trace, "parallel"), (trace_seq, "sequential")):
        w = sorted(r["wall_ms"] for r in t["rounds"]
                   if r["mode"] == "parallel")
        if w:
            log(f"    {name} draft mode: {len(w)} verify (branch-stage) "
                f"rounds, wall {w[0]:.2f}-{w[-1]:.2f} ms (median "
                f"{float(np.median(w)):.2f})")
    # the predictor at full width (sequential draft mode, greedy): the
    # decided-gamma histogram and rollback tokens beside off
    from repro_torch.obs import TraceRecorder
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len,
                        spec_predictor="on")
    rec = TraceRecorder()
    res, rep, counts, wall, eng = drive(pair, ecfg, prompts, n_new, dev,
                                        rec=rec)
    del eng
    for k, v in counts.items():
        totals[k] += v
    hist = {}
    for e in rec.events:
        if e["kind"] == "spec" and e.get("pred") is not None:
            hist[e["pred"]["gamma"]] = hist.get(e["pred"]["gamma"], 0) + 1
    rb = float(np.mean([r.stats.rollback_tokens for r in res.values()]))
    toks = sum(len(r.tokens) for r in res.values())
    off = out["specbranch sequential draft"]
    tf = teacher_forced(pair[2], pair[3], prompts, res, n_new,
                        greedy=greedy)
    log(f"  full specbranch predictor on: {toks / wall:.1f} tok/s wall, "
        f"rounds={rep['rounds']}, decided gamma histogram "
        f"{dict(sorted(hist.items()))}, rollback tokens per request {rb:.2f}"
        f" (off: {off['rollback_per_request']:.2f}, {off['rounds']} rounds,"
        f" {off['tokens_per_s']:.1f} tok/s)")
    if not hist:
        raise AssertionError("full predictor: no decision recorded")
    out["predictor"] = dict(gamma_hist=hist, rollback_per_request=rb,
                            rounds=rep["rounds"], tokens_per_s=toks / wall,
                            tf_argmax=tf["argmax"])
    return out


# ---------------------------------------------------------------------------
# phase 14: the cross-request prefix cache
# ---------------------------------------------------------------------------

def pc_tiny_trace(vocab: int, shared_len: int, seed: int):
    """The reference test's staggered shared-prompt trace: three prompts
    of ``shared_len`` shared tokens and 3 of their own, each arriving
    after the previous one retired (the reference's tests/
    test_prefix_cache.py:47-69)."""
    rng = np.random.default_rng(seed)
    shared = [int(x) for x in rng.integers(0, vocab, size=shared_len)]
    prompts = [shared + [int(x) for x in rng.integers(0, vocab, size=3)]
               for _ in range(3)]
    return prompts, [0.0, 300.0, 600.0]


class AdmissionClock:
    """While active, the host clock (after a device synchronise) at each
    request's admission (``reserve``), at the end of its admission
    group's prefill (``commit_admissions``) and at its first committed
    token (``_commit``): the wall TTFT of a serve, split into admission
    and the first round."""

    def __init__(self):
        from repro_torch.serving import batched_engine as BE
        self.cls = BE.BatchedEngineBase
        self.admit, self.admitted, self.first = {}, {}, {}

    def __enter__(self):
        self._orig = (self.cls.reserve, self.cls.commit_admissions,
                      self.cls._commit)
        reserve, commit_admissions, commit = self._orig

        def on_reserve(eng, rid, *a, **kw):
            torch.cuda.synchronize()
            self.admit.setdefault(rid, time.perf_counter())
            return reserve(eng, rid, *a, **kw)

        def on_commit_admissions(eng):
            rids = [p[0].rid for p in eng._pending_admits]
            commit_admissions(eng)
            torch.cuda.synchronize()
            for rid in rids:
                self.admitted.setdefault(rid, time.perf_counter())

        def on_commit(eng, seq, tokens, now):
            if tokens and seq.rid not in self.first:
                torch.cuda.synchronize()
                self.first[seq.rid] = time.perf_counter()
            return commit(eng, seq, tokens, now)
        (self.cls.reserve, self.cls.commit_admissions,
         self.cls._commit) = on_reserve, on_commit_admissions, on_commit
        return self

    def __exit__(self, *exc):
        (self.cls.reserve, self.cls.commit_admissions,
         self.cls._commit) = self._orig

    def ttft(self, rids) -> list:
        return [self.first[r] - self.admit[r] for r in rids]

    def split(self, rids) -> dict:
        """Medians over ``rids``, in ms: TTFT, its admission part (reserve
        to the end of the group's prefill) and its first round."""
        med = lambda xs: float(np.median(xs)) * 1e3  # noqa: E731
        return dict(
            ttft_ms=med(self.ttft(rids)),
            admission_ms=med([self.admitted[r] - self.admit[r]
                              for r in rids]),
            first_round_ms=med([self.first[r] - self.admitted[r]
                                for r in rids]))


class TargetPrefills:
    """While active, every prefill forward of the decoder whose model
    config is ``cfg`` (the target): its kind (full prompt or suffix),
    lanes x rung width and, with ``profile``, its device time, the sum of
    the CUDA kernels a ``torch.profiler`` session around the call saw."""

    def __init__(self, cfg, profile: bool = False):
        from repro_torch.serving import batched_engine as BE
        self.cls, self.cfg, self.profile = BE.BatchedDecoder, cfg, profile
        self.calls = []

    def __enter__(self):
        self._orig = {n: getattr(self.cls, n)
                      for n in ("prefill_rows", "prefill_rows_at")}
        for name, fn in self._orig.items():
            setattr(self.cls, name, self._spy(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.cls, name, fn)

    def _spy(self, name, fn):
        def call(dec, parts, *a):
            if dec.cfg is not self.cfg:
                return fn(dec, parts, *a)
            tb = DL.prefill_bucket(max(len(t) for _, t in parts),
                                   dec.prefill_quantum)
            rec = dict(kind="suffix" if name == "prefill_rows_at"
                       else "full", lanes=dec.prefill_lanes, width=tb,
                       used=len(parts))
            if not self.profile:
                out = fn(dec, parts, *a)
            else:
                torch.cuda.synchronize()
                acts = [torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    out = fn(dec, parts, *a)
                    torch.cuda.synchronize()
                rec["device_ms"] = sum(
                    e.duration_ns() for e in
                    prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA
                ) / 1e6
            self.calls.append(rec)
            return out
        return call


class SnapshotClock:
    """While active, each ring snapshot a decoder takes and each restore
    it makes: the snapshot's bytes on the host and the host time of each
    (a synchronise before; the snapshot's fetch inside, a synchronise
    after the restore's uploads)."""

    def __init__(self):
        from repro_torch.serving import batched_engine as BE
        self.cls = BE.BatchedDecoder
        self.snaps, self.restores = [], []

    def __enter__(self):
        self._snap, self._restore = snap, restore = (self.cls.snapshot,
                                                     self.cls.restore)

        def snapshot(dec, row, step, fetch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = snap(dec, row, step, fetch)
            self.snaps.append((dec.cfg.name, sum(
                a.numel() * a.element_size() for d in out
                for a in d.values()), time.perf_counter() - t0))
            return out

        def restore_(dec, row, step, sn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore(dec, row, step, sn)
            torch.cuda.synchronize()
            self.restores.append((dec.cfg.name, time.perf_counter() - t0))
        self.cls.snapshot, self.cls.restore = snapshot, restore_
        return self

    def __exit__(self, *exc):
        self.cls.snapshot, self.cls.restore = self._snap, self._restore


def pc_check(label, rep, eng, hits, saved) -> dict:
    pc = rep["prefix_cache"]
    if (pc["hits"], pc["saved_tokens"]) != (hits, saved):
        raise AssertionError(f"{label}: prefix cache hits "
                             f"{pc['hits']}/{pc['lookups']} saved "
                             f"{pc['saved_tokens']}, want {hits} and "
                             f"{saved}")
    eng.prefix_cache.check()
    return pc


def phase_prefix(dev, totals, pair) -> dict:
    """Phase 14; ``pair`` is the full-width LLaMA pair, dropped after its
    part so that falcon-mamba-7b fits."""
    t14 = time.time()
    log_phase("[14] prefix cache: tiny committed and jamba-shaped pairs "
              "(f32), full-width LLaMA-68M/7B and falcon-mamba-7b (bf16)")
    free_device_memory()
    out = {"tiny": phase_prefix_tiny(dev, totals)}
    free_device_memory()
    out["full"] = phase_prefix_full(dev, totals, pair)
    del pair
    out["falcon"] = phase_prefix_falcon(dev, totals)
    log(f"  phase 14: {time.time() - t14:.1f}s")
    return out


def phase_prefix_tiny(dev, totals) -> dict:
    """Both batched engines with the prefix cache on the tiny committed
    pair (greedy and temperature 1, shadowed) and the jamba-shaped pair
    (the rings' snapshot join): cache-on streams, prefix and pool stats
    equal the CPU serve's, and the streams the cache-off serve's."""
    from repro_torch.training.pairs import get_pair
    cache_dir = os.path.join(ROOT, ".cache", "pairs")
    out = {}
    drives = [("misaligned", engine, name, temp)
              for engine in ("specbranch", "sps")
              for name, temp in (("greedy", 0.0), ("temp1", 1.0))]
    drives.append(("jamba-shaped", "specbranch", "greedy", 0.0))
    for kind, engine, name, temp in drives:
        label = f"prefix tiny {kind} {engine} {name}"
        if kind == "misaligned":
            pair = get_pair(kind, device=dev, cache_dir=cache_dir)
            cpu = get_pair(kind, device="cpu", cache_dir=cache_dir)
            prompts, arrivals = pc_tiny_trace(pair[3].vocab_size, 8, 3)
            kw = dict(max_batch=3, page_size=4)
        else:
            pair = SV.load_pair(kind, dev)
            cpu = tree_to(pair, "cpu")
            prompts, arrivals = pc_tiny_trace(pair[3].vocab_size, 16, 5)
            kw = dict(max_batch=3, page_size=8)
        n_new = 16
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                            max_len=SV.auto_max_len(prompts, n_new, 4,
                                                    10.0))
        kw.update(engine=engine, arrivals=arrivals)
        with VerifyShadow() as sh, CountRestores() as cr:
            res, rep, counts, wall, eng = drive(pair, ecfg, prompts, n_new,
                                                dev, prefix_cache=True,
                                                **kw)
        for k, v in counts.items():
            totals[k] += v
        shared = 8 if kind == "misaligned" else 16
        pc = pc_check(label, rep, eng, 2, 2 * shared)
        cres, crep, ceng, cwall = SV.serve(cpu, ecfg, prompts, n_new,
                                           device="cpu", prefix_cache=True,
                                           **kw)
        assert_cpu_equal(label, res, cres)
        if crep["prefix_cache"] != pc or crep["pool"] != rep["pool"]:
            raise AssertionError(f"{label}: prefix or pool stats differ "
                                 "from the CPU serve's")
        ores, _, ocounts, owall, _ = drive(pair, ecfg, prompts, n_new, dev,
                                           prefix_cache=False, **kw)
        for k, v in ocounts.items():
            totals[k] += v
        if first_diff(res, ores) != {i: None for i in res}:
            raise AssertionError(f"{label}: cache-on streams differ from "
                                 "cache off")
        if temp > 0:
            check_shadow(label, sh, counts, chains=False)
        else:
            greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
            if [res[i].tokens for i in range(3)] != greedy:
                raise AssertionError(f"{label}: not the greedy decode")
        need = ["paged_attention"] + (["ssm_scan_ring"]
                                      if kind != "misaligned" else [])
        for k in need:
            if counts[k] == 0:
                raise AssertionError(f"{label}: {k} not launched")
        if kind != "misaligned" and (pc["snap_restores"] != 2
                                     or crep["prefix_cache"]
                                     ["snap_restores"] != 2 or cr.n != 4):
            raise AssertionError(f"{label}: snapshot restores "
                                 f"{pc['snap_restores']} (ring restores "
                                 f"{cr.n}), want 2 hits x 2 decoders")
        log(f"  {label}: hits={pc['hits']}/{pc['lookups']} saved="
            f"{pc['saved_tokens']} snap_restores={pc['snap_restores']} "
            f"rounds={rep['rounds']} wall={wall:.2f}s (off {owall:.2f}s, "
            f"CPU {cwall:.1f}s); streams, GenStats, prefix and pool stats "
            f"= the CPU serve's, streams = cache off; launches={counts}")
        out[label] = dict(prefix_cache=pc, wall_s=wall, off_wall_s=owall,
                          launches=counts)
        del eng, ceng
    return out


def phase_prefix_full(dev, totals, pair) -> dict:
    """The 7B pair: one request, then seven that share its 512-token
    system prompt arriving together after it retired; cache off against
    on: hits, saved tokens, the target's prefill forwards, staged tokens
    and device time (profiled serve), the followers' wall TTFT and the
    serve's wall tokens/s."""
    system = SV.make_prompts(1, length=512, seed=5)[0]
    prompts = [system + p for p in SV.make_prompts(8, length=32, seed=9)]
    arrivals = [0.0] + [1e6] * 7
    n_new = LATE_NEW
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                        max_len=SV.auto_max_len(prompts, n_new, 4, 10.0))
    followers = list(range(1, 8))
    out, streams = {}, {}
    # timed serves off, on, on, off (a host's speed drifts within a call);
    # then one profiled serve each: a profiler session slows the serves
    # after it, so none is timed after one
    for i, cache in enumerate((False, True, True, False)):
        label = f"prefix 7B cache {'on' if cache else 'off'}"
        with AdmissionClock() as ac, TargetPrefills(pair[3]) as tp:
            res, rep, counts, wall, eng = drive(
                pair, ecfg, prompts, n_new, dev, prefix_cache=cache,
                arrivals=arrivals)
        for k, v in counts.items():
            totals[k] += v
        tokens = [res[i].tokens for i in range(8)]
        if streams.setdefault(cache, tokens) != tokens:
            raise AssertionError(f"{label}: streams differ between runs")
        pc = (pc_check(label, rep, eng, 7, 7 * 512) if cache else None)
        del eng
        free_device_memory()
        ttft = ac.ttft(followers)
        fol = tp.calls[1:]          # the followers' admission group
        toks = sum(len(r.tokens) for r in res.values())
        o = out.setdefault(label, dict(
            prefill_calls=tp.calls, follower_forwards=len(fol),
            follower_staged_tokens=sum(c["lanes"] * c["width"]
                                       for c in fol),
            prefix_cache=pc, launches=counts, runs=[]))
        o["runs"].append(dict(wall_s=wall, tokens_per_s=toks / wall,
                              ttft_p50_s=float(np.median(ttft)),
                              ttft_max_s=max(ttft),
                              **ac.split(followers)))
        r = o["runs"][-1]
        log(f"  {label} (timed run {i + 1}): followers' wall TTFT p50 "
            f"{r['ttft_p50_s'] * 1e3:.1f} ms (admission "
            f"{r['admission_ms']:.1f} + first round "
            f"{r['first_round_ms']:.1f}), max "
            f"{r['ttft_max_s'] * 1e3:.1f} ms; {r['tokens_per_s']:.1f} "
            f"tok/s wall ({wall:.2f}s); target prefill of the followers: "
            f"{o['follower_forwards']} forward(s), "
            f"{o['follower_staged_tokens']} staged tokens "
            f"({[(c['kind'], c['lanes'], c['width']) for c in fol]}); "
            + (f"hits={pc['hits']}/{pc['lookups']} "
               f"saved={pc['saved_tokens']}; " if pc else "")
            + f"launches={counts}")
    for cache in (False, True):
        label = f"prefix 7B cache {'on' if cache else 'off'}"
        with TargetPrefills(pair[3], profile=True) as pp:
            SV.serve(pair, ecfg, prompts, n_new, device=dev,
                     prefix_cache=cache, arrivals=arrivals)
        free_device_memory()
        dev_ms = [c["device_ms"] for c in pp.calls]
        out[label].update(first_prefill_ms=dev_ms[0],
                          follower_prefill_ms=sum(dev_ms[1:]))
        log(f"  {label} (profiled): target prefill device time, request "
            f"0's {dev_ms[0]:.2f} ms, the followers' "
            f"{sum(dev_ms[1:]):.2f} ms")
    if streams[True] != streams[False]:
        raise AssertionError("prefix 7B: cache-on streams differ from "
                             "cache off")
    log("  prefix 7B: streams on == off")
    return out


def phase_prefix_falcon(dev, totals) -> dict:
    """falcon-mamba-7b: one request, then three that share its 256-token
    prompt (each with 16 tokens of its own, so the published run ends at
    256 with the rings' snapshot) arriving together after it retired;
    cache on against off: snapshot restores, the snapshot bytes a
    publish candidate takes and their host time, streams equal."""
    free_device_memory()
    pair = SV.load_pair("falcon-mamba-7b", dev)
    system = SV.make_prompts(1, length=256, seed=5)[0]
    prompts = [system + p for p in SV.make_prompts(4, length=16, seed=9)]
    arrivals = [0.0] + [1e6] * 3
    n_new = 16
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                        max_len=SV.auto_max_len(prompts, n_new, 4, 10.0))
    out, streams = {}, {}
    for i, cache in enumerate((False, True, True, False)):
        label = f"prefix falcon cache {'on' if cache else 'off'}"
        with SnapshotClock() as sc, CountRestores() as cr, \
                RingCensus() as census, AdmissionClock() as ac, \
                TargetPrefills(pair[3]) as tp:
            res, rep, counts, wall, eng = drive(
                pair, ecfg, prompts, n_new, dev, prefix_cache=cache,
                arrivals=arrivals, max_batch=4)
        for k, v in counts.items():
            totals[k] += v
        tokens = [res[j].tokens for j in range(4)]
        if streams.setdefault(cache, tokens) != tokens:
            raise AssertionError(f"{label}: streams differ between runs")
        pc = pc_check(label, rep, eng, 3, 3 * 256) if cache else None
        del eng
        free_device_memory()
        if cache:
            if pc["snap_restores"] != 3 or cr.n != 6:
                raise AssertionError(f"{label}: snap_restores "
                                     f"{pc['snap_restores']}, ring "
                                     f"restores {cr.n}; want 3 and 6")
            if census.shapes[(4, 16, pair[3].d_inner, FALCON_RING, 4)] == 0:
                raise AssertionError(f"{label}: no suffix ring scan at "
                                     "phase 2's shape")
        per_pub = {}
        for name, nbytes, secs in sc.snaps:
            per_pub.setdefault(name, []).append((nbytes, secs))
        o = out.setdefault(label, dict(
            snap_restores=pc["snap_restores"] if pc else 0,
            snapshots={n: dict(count=len(v), bytes=v[0][0])
                       for n, v in per_pub.items()},
            follower_prefill=[(c["kind"], c["lanes"], c["width"])
                              for c in tp.calls[1:]],
            ring_scans=dict(census.shapes.most_common(6)),
            launches=counts, runs=[]))
        o["runs"].append(dict(
            wall_s=wall, **ac.split([1, 2, 3]),
            restore_host_ms=[t * 1e3 for _, t in sc.restores],
            snapshot_host_ms={n: [t * 1e3 for _, t in v]
                              for n, v in per_pub.items()}))
        r = o["runs"][-1]
        log(f"  {label} (run {i + 1}): snap_restores={o['snap_restores']}"
            + "".join(f", snapshots {n}: {len(v)} x "
                      f"{o['snapshots'][n]['bytes'] / 1e6:.2f} MB, host "
                      f"{np.median(v):.2f} ms median"
                      for n, v in r["snapshot_host_ms"].items())
            + (f"; restores {len(sc.restores)}, host "
               f"{sum(r['restore_host_ms']):.2f} ms in all"
               if sc.restores else "")
            + f"; followers' wall TTFT p50 {r['ttft_ms']:.1f} ms "
            f"(admission {r['admission_ms']:.1f} + first round "
            f"{r['first_round_ms']:.1f}); their target prefill "
            f"{o['follower_prefill']}; ring scans {o['ring_scans']}; "
            f"{wall:.2f}s wall; launches={counts}")
    if streams[True] != streams[False]:
        raise AssertionError("prefix falcon: cache-on streams differ from "
                             "cache off")
    log("  prefix falcon: streams on == off")
    del pair
    free_device_memory()
    return out


# ---------------------------------------------------------------------------
# phase 15: architecture coverage
# ---------------------------------------------------------------------------

def family_draft(tcfg):
    """tests/test_arch_serving.py's same-family draft of a reduced
    target: one period, d_model 128, two heads of 64."""
    return tcfg.replace(name=tcfg.name + "-draft",
                        num_layers=tcfg.period, d_model=128,
                        num_heads=2, num_kv_heads=1, head_dim=64,
                        d_ff=min(tcfg.d_ff, 256) if tcfg.d_ff else 0,
                        moe_d_ff=128 if tcfg.num_experts else 0,
                        num_experts=min(tcfg.num_experts, 2) or 0,
                        num_experts_per_tok=min(tcfg.num_experts_per_tok,
                                                2) or 0)


def phase_arch(dev, totals) -> dict:
    t15 = time.time()
    log_phase("[15] architecture coverage: the ten reduced configs (f32), "
              "gemma3-4b, granite-moe-3b-a800m, internvl2-2b and "
              "hubert-xlarge at full width (bf16)")
    out = {}
    for name, part in (("reduced", phase_arch_reduced),
                       ("gemma3-4b", phase_arch_gemma3),
                       ("granite-moe-3b-a800m", phase_arch_granite),
                       ("internvl2-2b", phase_arch_vlm),
                       ("hubert-xlarge", phase_arch_hubert)):
        free_device_memory()
        t0 = time.time()
        out[name] = part(dev, totals)
        log(f"  phase 15 {name}: {time.time() - t0:.1f}s")
    free_device_memory()
    log(f"  phase 15: {time.time() - t15:.1f}s")
    return out


def phase_arch_reduced(dev, totals) -> dict:
    """Every assigned config's reduced() target, f32, random weights
    (target seed 0, draft seed 1).  The nine that decode, with
    ``family_draft``: sequential SpS and SpecBranch greedy on the card
    must equal the same serve on the CPU and the port's greedy decode.
    hubert: a cache-less bidirectional forward over stub frames, card
    against CPU within 1e-4."""
    from repro_torch.configs import ARCH_IDS, get_config
    out = {}
    for arch in ARCH_IDS:
        tcfg = get_config(arch).reduced()
        tp = M.init_params(tcfg, 0, dev)
        if not tcfg.supports_decode():
            frames = torch.from_numpy(np.random.default_rng(5)
                                      .standard_normal((2, 16, tcfg.d_model))
                                      .astype(np.float32))
            ops.reset_launches()
            with torch.no_grad():
                lg, _ = M.forward(tp, tcfg, embeds=frames.to(dev))
                torch.cuda.synchronize()
                counts = dict(ops.LAUNCHES)
                lc, _ = M.forward(tree_to(tp, "cpu"), tcfg, embeds=frames)
            for k, v in counts.items():
                totals[k] += v
            err = float((lg.cpu() - lc).abs().max())
            log(f"  {arch} reduced: bidirectional forward {tuple(lg.shape)},"
                f" card vs CPU max err {err:.2e}, flash launches "
                f"{counts['flash_attention']}")
            if not err <= 1e-4 or counts["flash_attention"] != \
                    tcfg.num_layers:
                raise AssertionError(f"{arch} reduced: forward err {err} / "
                                     f"launches {counts}")
            out[arch] = dict(max_abs_err=err, launches=counts)
            continue
        dcfg = family_draft(tcfg)
        pair = (M.init_params(dcfg, 1, dev), dcfg, tp, tcfg)
        cpu = tree_to(pair, "cpu")
        prompt = [int(t) for t in np.random.default_rng(3).integers(
            0, tcfg.vocab_size, size=6)]
        greedy = RN.greedy_reference(tp, tcfg, prompt, ARCH_N_NEW,
                                     max_len=256)
        need = tuple(k for k, on in (
            ("flash_attention", tcfg.has_attention()),
            ("ssm_scan", any(m == "mamba" for m, _ in tcfg.pattern))) if on)
        ecfg = EngineConfig(gamma=3, c=4.0, temperature=0.0, epsilon=0.4,
                            signal_temperature=0.5, max_len=256)
        out[arch] = {}
        for name in ("sps", "specbranch"):
            res, counts, wall = seq_drive(pair, ecfg, name, [prompt],
                                          ARCH_N_NEW, totals, need=need)
            cres, _, _ = SV.serve_sequential(cpu, ecfg, name, [prompt],
                                             ARCH_N_NEW)
            card, on_cpu = res[0].tokens, cres[0].result.tokens
            log(f"  {arch} reduced {name}: card == CPU {card == on_cpu}, "
                f"== greedy {card == greedy}, M="
                f"{res[0].stats.mean_accepted:.2f}, launches "
                f"{ {k: counts[k] for k in need} }")
            if card != greedy or on_cpu != card:
                raise AssertionError(f"{arch} reduced {name}: card "
                                     f"{card}, CPU {on_cpu}, greedy {greedy}")
            out[arch][name] = dict(wall_s=wall, launches=counts,
                                   mean_accepted=res[0].stats.mean_accepted)
        del pair, cpu
    return out


def phase_arch_gemma3(dev, totals) -> dict:
    """gemma3-4b at full width with its draft() (hd 160), bf16, random
    weights (target seed 0, draft seed 1): 8 requests of 1000-token
    prompts and G3_NEW (32) new tokens, so the last positions lie past
    the local layers' window (1024).
    Batched SpecBranch on the paged backend greedy (teacher-forced, with
    the serve's own target logits held against the cache-less forward's)
    and at temperature 1 with epsilon 0, G3_T1_NEW new tokens (shadowed:
    the batched verify at V = 262144), the same greedy serve on the dense
    backend (its streams must be the paged serve's), sequential
    SpecBranch 1 x 32 greedy (teacher-forced); tokens/s, rounds, M, peak
    memory; how far the target's logits move when its context changes
    (the yardstick of the logit comparison).  (Its profiled serve went
    for time when granite's drive came: PERF.md keeps its busy shares.)"""
    from repro_torch.configs import gemma3_4b
    base = torch.cuda.memory_allocated()
    pair = SV.load_pair("gemma3-4b", dev)
    dcfg, tcfg = pair[1], pair[3]
    if tcfg != gemma3_4b.CONFIG or (dcfg.num_layers, dcfg.d_model,
                                    dcfg.hd) != (12, 320, 160):
        raise AssertionError("gemma3-4b or its draft is not at full width")
    wt, wd = tree_bytes(pair[2]), tree_bytes(pair[0])
    log(f"  weights: target {wt / 1e9:.3f} GB ({tcfg.param_count()} "
        f"params), draft {wd / 1e9:.3f} GB ({dcfg.param_count()}); "
        f"{(torch.cuda.memory_allocated() - base) / 1e9:.2f} GB allocated")
    prompts = SV.make_prompts(8, length=G3_PROMPT)
    n_new = G3_NEW
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    out = {"weights_gb": (wt + wd) / 1e9}
    served = {}
    for name, temp, eps, backend, n in (
            ("paged greedy", 0.0, EPS, "paged", n_new),
            ("paged temp1-chains", 1.0, 0.0, "paged", G3_T1_NEW),
            ("dense greedy", 0.0, EPS, "dense", n_new)):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, epsilon=eps,
                            max_len=max_len)
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        with VerifyShadow() as sh, ServedLogits(prompts, tcfg) as sl:
            res, rep, counts, wall, eng = drive(pair, ecfg, prompts, n, dev,
                                                attn_backend=backend)
        peak = torch.cuda.max_memory_allocated()
        del eng
        for k, v in counts.items():
            totals[k] += v
        toks = sum(len(r.tokens) for r in res.values())
        mean_acc = float(np.mean([r.stats.mean_accepted
                                  for r in res.values()]))
        log(f"  gemma3-4b {name}: {toks / wall:.1f} tok/s wall, "
            f"rounds={rep['rounds']}, mean accepted={mean_acc:.2f}, peak "
            f"allocated {peak / 1e9:.2f} GB, launches={counts}")
        kern = "paged_attention" if backend == "paged" else "flash_attention"
        if counts[kern] == 0:
            raise AssertionError(f"gemma3-4b {name}: {kern} not run")
        out[name] = dict(tokens_per_s=toks / wall, wall_s=wall,
                         rounds=rep["rounds"], mean_accepted=mean_acc,
                         tokens=toks, peak_gb=peak / 1e9, launches=counts)
        if temp == 0.0:
            out[name]["teacher_forced"] = tf = teacher_forced(
                pair[2], tcfg, prompts, res, n_new, served=sl)
            served[name] = (res, tf["top2"])
        else:
            if counts["verify_accept_batched"] == 0:
                raise AssertionError("gemma3-4b temp1: verify not launched")
            check_shadow(f"gemma3-4b {name}", sh, counts, chains=True)
        del sl
    (pres, ptop2), (dres, _) = served["paged greedy"], served["dense greedy"]
    first = first_diff(pres, dres)
    near = {i: round(ptop2[i][j], 5) for i, j in first.items()
            if j is not None}
    n_eq = sum(j is None for j in first.values())
    log(f"  gemma3-4b dense vs paged greedy: {n_eq}/{len(first)} streams "
        f"equal; first divergence {first}, the paged stream's top-2 gap "
        f"there {near}")
    if n_eq != len(first):
        raise AssertionError("gemma3-4b: dense and paged greedy streams "
                             "differ")
    out["context_yardstick"] = context_yardstick(pair[2], tcfg, prompts,
                                                 pres, n_new)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    res, counts, wall = seq_drive(pair, ecfg, "specbranch", prompts[:1], 32,
                                  totals)
    rounds = len(res[0].timeline)
    log(f"  gemma3-4b sequential specbranch 1 x 32: {32 / wall:.1f} tok/s "
        f"wall, rounds={rounds}, mean accepted="
        f"{res[0].stats.mean_accepted:.2f}, flash launches "
        f"{counts['flash_attention']}")
    out["seq specbranch"] = dict(
        tokens_per_s=32 / wall, wall_s=wall, rounds=rounds,
        mean_accepted=res[0].stats.mean_accepted, launches=counts,
        teacher_forced=teacher_forced(pair[2], tcfg, prompts[:1], res, 32))
    return out


class HeadDimLaunches:
    """While active, counts the paged and flash wrappers' calls (one
    launch each) by head dim."""

    def __enter__(self):
        from collections import Counter
        self.counts = Counter()
        self._orig = (PA.paged_attention, FA.flash_attention)

        def spy(name, fn):
            def call(q, *a, **kw):
                if q.numel():
                    self.counts[(name, q.shape[-1])] += 1
                return fn(q, *a, **kw)
            return call
        PA.paged_attention = spy("paged_attention", self._orig[0])
        FA.flash_attention = spy("flash_attention", self._orig[1])
        return self

    def __exit__(self, *exc):
        PA.paged_attention, FA.flash_attention = self._orig
        return False

    def by_hd(self) -> dict:
        return {f"{n} hd{hd}": c for (n, hd), c in sorted(self.counts.items())}


class MoeDrops:
    """While active, counts the (token, choice) pairs every MoE forward
    routes and those past their expert's capacity, which ``moe_ffn``
    drops: the same router, top-k and capacity recomputed beside the
    layer (device sums; read once at the end)."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self.L, self._orig = L, L.moe_ffn
        self.pairs = 0
        self.dropped = None

        def spy(p, x, cfg, tp=None, dp=None):
            with torch.no_grad():
                n = x.shape[0] * x.shape[1]
                h = L.rms_norm(x, p["ln"], cfg.norm_eps).reshape(n, -1)
                probs = torch.softmax(h.float() @ p["router"], dim=-1)
                eidx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)[1]
                per = torch.bincount(eidx.reshape(-1),
                                     minlength=cfg.num_experts)
                over = (per - L.moe_capacity(cfg, n)).clamp_min(0).sum()
                self.dropped = over if self.dropped is None \
                    else self.dropped + over
                self.pairs += n * cfg.num_experts_per_tok
            return self._orig(p, x, cfg, tp=tp, dp=dp)
        L.moe_ffn = spy
        return self

    def __exit__(self, *exc):
        self.L.moe_ffn = self._orig
        return False

    def share(self) -> float:
        return (0.0 if self.dropped is None
                else int(self.dropped) / max(self.pairs, 1))


def drop_free(cfg):
    """``cfg`` with the capacity that drops no (token, choice) pair,
    num_experts / num_experts_per_tok, as ``reduced()`` sets it: a token's
    routing then does not depend on the batch it is served in."""
    return cfg.replace(capacity_factor=cfg.num_experts
                       / cfg.num_experts_per_tok)


def phase_arch_granite(dev, totals) -> dict:
    """granite-moe-3b-a800m at full width (32 layers, d 1536, 40 experts
    top-8 on every layer) with its draft() (2 layers, d 256, 3 heads of hd
    85: the decode loop's ragged path), bf16, random weights (target seed
    0, draft seed 1): 8 requests of GRANITE_PROMPT-token prompts and
    GRANITE_NEW new tokens.  The greedy gate runs on drop-free copies of
    both configs (``drop_free``): at the configs' capacity factor 1.25 a
    batched verify and the cache-less forward may route one token
    differently.  Batched SpecBranch on the paged backend, greedy,
    teacher-forced; the same serve on the dense backend, whose streams
    must equal the paged ones; sequential SpecBranch 1 x GRANITE_NEW,
    teacher-forced.  The paged and flash kernels must launch at hd 85
    (launches by head dim).  Then one paged serve at capacity 1.25 under
    the CUDA profiler (8 x 8): in-vocabulary tokens, the share of (token,
    choice) pairs dropped, the busy share and the draft's attention
    (the ragged path's kernels) in the device time.  tokens/s, rounds,
    M, peak memory and weight bytes."""
    from repro_torch.configs import granite_moe_3b_a800m
    base = torch.cuda.memory_allocated()
    pair = SV.load_pair("granite-moe-3b-a800m", dev)
    dcfg, tcfg = pair[1], pair[3]
    if tcfg != granite_moe_3b_a800m.CONFIG or (
            dcfg.num_layers, dcfg.d_model, dcfg.num_heads,
            dcfg.hd) != (2, 256, 3, 85):
        raise AssertionError("granite-moe-3b-a800m or its draft is not at "
                             "full width")
    wt, wd = tree_bytes(pair[2]), tree_bytes(pair[0])
    log(f"  weights: target {wt / 1e9:.3f} GB ({tcfg.param_count()} "
        f"params), draft {wd / 1e9:.3f} GB ({dcfg.param_count()}); "
        f"{(torch.cuda.memory_allocated() - base) / 1e9:.2f} GB allocated")
    free = (pair[0], drop_free(dcfg), pair[2], drop_free(tcfg))
    log(f"  greedy gate on drop-free copies: capacity_factor "
        f"{free[3].capacity_factor} (target), {free[1].capacity_factor} "
        f"(draft); the configs' own {tcfg.capacity_factor}")
    prompts = SV.make_prompts(8, length=GRANITE_PROMPT)
    n_new = GRANITE_NEW
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    out = {"weights_gb": (wt + wd) / 1e9}
    served = {}
    for name, backend in (("paged greedy", "paged"),
                          ("dense greedy", "dense")):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        with HeadDimLaunches() as hl:
            res, rep, counts, wall, eng = drive(free, ecfg, prompts, n_new,
                                                dev, attn_backend=backend)
        peak = torch.cuda.max_memory_allocated()
        del eng
        for k, v in counts.items():
            totals[k] += v
        toks = sum(len(r.tokens) for r in res.values())
        mean_acc = float(np.mean([r.stats.mean_accepted
                                  for r in res.values()]))
        log(f"  granite {name}: {toks / wall:.1f} tok/s wall, "
            f"rounds={rep['rounds']}, mean accepted={mean_acc:.2f}, peak "
            f"allocated {peak / 1e9:.2f} GB, launches={counts}, by head "
            f"dim {hl.by_hd()}")
        kern = "paged_attention" if backend == "paged" else "flash_attention"
        if hl.counts[(kern, 85)] == 0:
            raise AssertionError(f"granite {name}: {kern} not run at hd 85")
        out[name] = dict(tokens_per_s=toks / wall, wall_s=wall,
                         rounds=rep["rounds"], mean_accepted=mean_acc,
                         tokens=toks, peak_gb=peak / 1e9, launches=counts,
                         by_hd=hl.by_hd(),
                         teacher_forced=teacher_forced(free[2], free[3],
                                                       prompts, res, n_new))
        served[name] = res
    first = first_diff(served["paged greedy"], served["dense greedy"])
    n_eq = sum(j is None for j in first.values())
    log(f"  granite dense vs paged greedy: {n_eq}/{len(first)} streams "
        f"equal; first divergence {first}")
    if n_eq != len(first):
        raise AssertionError("granite: dense and paged greedy streams "
                             "differ")
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    with HeadDimLaunches() as hl:
        res, counts, wall = seq_drive(free, ecfg, "specbranch", prompts[:1],
                                      n_new, totals)
    rounds = len(res[0].timeline)
    log(f"  granite sequential specbranch 1 x {n_new}: {n_new / wall:.1f} "
        f"tok/s wall, rounds={rounds}, mean accepted="
        f"{res[0].stats.mean_accepted:.2f}, by head dim {hl.by_hd()}")
    if hl.counts[("flash_attention", 85)] == 0:
        raise AssertionError("granite sequential: flash not run at hd 85")
    out["seq specbranch"] = dict(
        tokens_per_s=n_new / wall, wall_s=wall, rounds=rounds,
        mean_accepted=res[0].stats.mean_accepted, launches=counts,
        teacher_forced=teacher_forced(free[2], free[3], prompts[:1], res,
                                      n_new))
    # the configs' own capacity: one profiled paged serve, 8 x 8
    free_device_memory()
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    box = {}

    def run():
        box["res"] = SV.serve(pair, ecfg, prompts, 8, device=dev,
                              attn_backend="paged")[0]
    with MoeDrops() as md:
        prof = busy_profile(run)
    bad = [t for r in box["res"].values() for t in r.tokens
           if not 0 <= t < tcfg.vocab_size]
    if bad or any(len(r.tokens) != 8 for r in box["res"].values()):
        raise AssertionError(f"granite at capacity 1.25: tokens {bad}")
    rag = prof["ragged_ms"]
    log(f"  granite at capacity {tcfg.capacity_factor} (8 x 8, paged, "
        f"profiled): {md.pairs} (token, choice) pairs routed, "
        f"{md.share():.4f} of them dropped; card busy "
        f"{prof['busy_share']:.3f} of {prof['wall_s']:.2f}s wall, device "
        f"{prof['device_s'] * 1e3:.1f} ms, the draft's attention (the "
        f"ragged path's kernels) {rag:.2f} ms over "
        f"{prof['ragged_launches']} launches = "
        f"{rag / 1e3 / prof['device_s']:.4f} of it; device time by kernel:")
    for n, t in prof["top"]:
        log(f"    {t * 1e3:9.2f} ms  {n}")
    log_paged(prof)
    out["capacity 1.25"] = dict(drop_share=md.share(), pairs=md.pairs,
                                draft_attention_ms=rag, profile=prof)
    return out


def context_yardstick(tp, tcfg, prompts, res, n_new) -> dict:
    """How far request 0's target logits at its served positions move
    under two context faults, each a cache-less forward: the keys its
    local rings evicted left visible (the window off), and the first
    P - 8 prompt tokens swapped for request 1's (a prefill that wrote the
    wrong keys).  The yardstick of ``teacher_forced(served=)``'s logit
    comparison: a fault shows there only where it moves the logits by
    more than TF_MARGIN, which the wrong prefill must do."""
    P = len(prompts[0])

    def logits(cfg, seq):
        t = torch.tensor([seq], device=tp["embed"].device)
        with torch.no_grad():
            lg, _ = M.forward(tp, cfg, t)
        return lg[0, P - 1:P - 1 + n_new].float()
    tail = res[0].tokens
    want = logits(tcfg, list(prompts[0]) + tail)
    # positions whose window has evicted a key: q >= window
    wrapped = slice(max(0, tcfg.sliding_window - P + 1), n_new)
    ring = float((logits(tcfg.replace(sliding_window=0),
                         list(prompts[0]) + tail) - want)[wrapped]
                 .abs().max())
    swapped = list(prompts[1][:P - 8]) + list(prompts[0][P - 8:]) + tail
    ctx = float((logits(tcfg, swapped) - want).abs().max())
    out = dict(evicted_keys_visible=ring, other_prompt=ctx,
               margin=TF_MARGIN)
    log(f"  gemma3-4b context yardstick (request 0): evicted keys visible "
        f"move its logits by up to {ring:.5f} at the wrapped positions, "
        f"another prompt's first {P - 8} tokens by up to {ctx:.5f} "
        f"(the served-logit margin is {TF_MARGIN})")
    if not ctx > TF_MARGIN:
        raise AssertionError("gemma3-4b: another prompt moves the logits "
                             f"by only {ctx}: the served-logit comparison "
                             "cannot see a wrong prefill")
    return out


def phase_arch_vlm(dev, totals) -> dict:
    """internvl2-2b at full width with its draft() (hd 128), bf16, random
    weights: each request gets 256 seeded stub patch embeddings (the
    draft its own, at its width) then a 32-token prompt; sequential AR,
    SpS and SpecBranch, 2 requests x VLM_NEW tokens, greedy, each token
    teacher-forced against a cache-less target forward over embeddings +
    prompt + stream."""
    from repro_torch.configs import internvl2_2b
    from repro_torch.runtime import prng
    from repro_torch.runtime.scheduler import Request, Scheduler
    pair = SV.load_pair("internvl2-2b", dev)
    dcfg, tcfg = pair[1], pair[3]
    if tcfg != internvl2_2b.CONFIG or dcfg.hd != 128:
        raise AssertionError("internvl2-2b or its draft is not at full width")
    prompts = SV.make_prompts(2, length=VLM_PROMPT)
    rng = np.random.default_rng(11)

    def stub(d):
        return torch.from_numpy(rng.standard_normal(
            (1, VLM_PATCHES, d)).astype(np.float32)).to(dev, tcfg.tdtype)
    t_emb = [stub(tcfg.d_model) for _ in prompts]
    d_emb = [stub(dcfg.d_model) for _ in prompts]
    max_len = SV.auto_max_len([[0] * (VLM_PATCHES + VLM_PROMPT)], VLM_NEW,
                              4, 10.0)
    out = {}
    for name in ("autoregressive", "sps", "specbranch"):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                            max_len=max_len)
        eng = SV.build_engine(name, pair, ecfg)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=VLM_NEW,
                        embeds=t_emb[i] if name == "autoregressive"
                        else (t_emb[i], d_emb[i]))
                for i, p in enumerate(prompts)]
        ops.reset_launches()
        t0 = time.time()
        Scheduler(eng).run(reqs, key=prng.PRNGKey(0))
        wall = time.time() - t0
        counts = dict(ops.LAUNCHES)
        for k, v in counts.items():
            totals[k] += v
        res = {r.rid: r.result for r in reqs}
        if any(len(r.tokens) != VLM_NEW for r in res.values()) \
                or counts["flash_attention"] == 0:
            raise AssertionError(f"internvl2-2b {name}: {counts}")
        log(f"  internvl2-2b {name} ({VLM_PATCHES} patches + "
            f"{VLM_PROMPT} tokens): "
            f"{len(prompts) * VLM_NEW / wall:.1f} tok/s wall, rounds="
            f"{sum(len(r.timeline) for r in res.values())}, flash launches "
            f"{counts['flash_attention']}")
        out[name] = dict(tokens_per_s=len(prompts) * VLM_NEW / wall,
                         wall_s=wall, launches=counts,
                         teacher_forced=teacher_forced(
                             pair[2], tcfg, prompts, res, VLM_NEW,
                             embeds=t_emb))
        del eng
    return out


def phase_arch_hubert(dev, totals) -> dict:
    """hubert-xlarge at full width, bf16, random weights (seed 0): one
    cache-less bidirectional forward over (2, 500, 1280) seeded frames;
    finite (2, 500, 504) logits; the flash kernel once per layer, every
    call with causal False; the forward's time and its flash device time
    beside phase 2's SDPA case at the same attention shape."""
    from repro_torch.configs import get_config
    cfg = get_config("hubert-xlarge")
    tp = M.init_params(cfg, 0, dev)
    frames = torch.from_numpy(np.random.default_rng(8).standard_normal(
        HUBERT_FRAMES + (cfg.d_model,)).astype(np.float32)).to(dev,
                                                              cfg.tdtype)
    causal = []
    orig = ops.flash_attention

    def flash(*a, **kw):
        causal.append(kw.get("causal", True))
        return orig(*a, **kw)

    def fwd():
        with torch.no_grad():
            return M.forward(tp, cfg, embeds=frames)[0]
    ops.flash_attention = flash
    try:
        ops.reset_launches()
        lg = fwd()
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
    finally:
        ops.flash_attention = orig
    for k, v in counts.items():
        totals[k] += v
    ok = (tuple(lg.shape) == HUBERT_FRAMES + (cfg.vocab_size,)
          and bool(torch.isfinite(lg).all()))
    log(f"  hubert-xlarge forward {tuple(lg.shape)} finite={ok}: flash "
        f"launches {counts['flash_attention']}, causal flags "
        f"{sorted(set(causal))}")
    if not ok or counts["flash_attention"] != cfg.num_layers \
            or causal != [False] * cfg.num_layers:
        raise AssertionError(f"hubert-xlarge: {counts}, causal {causal}")
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.time()
        fwd()
        torch.cuda.synchronize()
        walls.append((time.time() - t0) * 1e3)
    ms = float(np.median(walls[2:]))
    prof = busy_profile(fwd)
    log(f"  hubert-xlarge forward: {ms:.2f} ms wall (median of 5, "
        f"synchronised), device time {prof['device_s'] * 1e3:.2f} ms, busy "
        f"{prof['busy_share']:.3f}; flash {prof['flash_ms']:.3f} ms over "
        f"{prof['flash_launches']} launches (phase 2's {HUBERT_CASE} case "
        "has SDPA beside it); device time by kernel:")
    for n, t in prof["top"]:
        log(f"    {t * 1e3:9.2f} ms  {n}")
    return dict(forward_ms=ms, launches=counts, profile=prof)


# ---------------------------------------------------------------------------
# phase 16: training
# ---------------------------------------------------------------------------

def add_counts(totals, counts) -> None:
    for k, v in counts.items():
        totals[k] += v


def phase_train(dev, totals) -> dict:
    t16 = time.time()
    log_phase("[16] training: the tiny pairs, heads and H-RAD MLP trained on "
              "the card (f32); the ten reduced configs card == CPU; "
              "gemma3-4b full width and falcon-mamba-7b at 16 layers (bf16)")
    out = {}
    for name, part in (("tiny", phase_train_tiny),
                       ("reduced", phase_train_reduced),
                       ("gemma3-4b", phase_train_gemma3),
                       ("falcon-mamba-7b", phase_train_falcon)):
        free_device_memory()
        t0 = time.time()
        out[name] = part(dev, totals)
        log(f"  phase 16 {name}: {time.time() - t0:.1f}s")
    free_device_memory()
    log(f"  phase 16: {time.time() - t16:.1f}s")
    return out


def phase_train_tiny(dev, totals) -> dict:
    """(a) The committed pair's aligned draft (zm-draft-ali, 400 steps),
    the misaligned draft's parallel-draft heads (K=4, 200 steps) and its
    H-RAD MLP (collect over 6 x 48 tokens, 12 epochs), each trained on
    the card into a fresh port cache (the launch counters zeroed before
    and read after: the flash backward must run); measure_alpha of both
    drafts (the engines' draft temperature 1 as the reference measures,
    and greedy drafts, whose argmax agreement the training budgets aim
    at: ali must beat mis there); then batched SpecBranch serving in
    parallel draft mode with the trained heads and MLP, greedy, whose
    streams must equal the target's greedy decode."""
    from repro_torch.training import pairs as TP
    cache = tempfile.mkdtemp(prefix="torch_pairs_", dir=ROOT)
    TP.TORCH_CACHE_DIR = cache
    out = {}
    try:
        ops.reset_launches()
        t0 = time.time()
        ali = TP.get_pair("aligned", device=dev)
        t_ali = time.time() - t0
        t0 = time.time()
        heads = TP.draft_heads_for("misaligned", device=dev)
        t_heads = time.time() - t0
        t0 = time.time()
        mlp = TP.hrad_for_pair("misaligned", device=dev)
        t_hrad = time.time() - t0
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        add_counts(totals, counts)
        files = sorted(os.listdir(cache))
        log(f"  trained on the card: zm-draft-ali {TP.ALI_STEPS} steps "
            f"{t_ali:.1f}s, heads {t_heads:.1f}s, H-RAD MLP {t_hrad:.1f}s; "
            f"files {files}; launches {counts}")
        if counts["flash_attention_bwd"] == 0 or len(files) != 3:
            raise AssertionError(f"tiny training: {counts} / {files}")
        mis = TP.get_pair("misaligned", device=dev)
        alpha = {}
        for kind, pair in (("mis", mis), ("ali", ali)):
            for temp in (1.0, 0.0):
                alpha[f"{kind} t={temp:g}"] = TP.measure_alpha(
                    *pair, draft_temperature=temp)
        log(f"  measure_alpha (draft temperature 1 / greedy): "
            f"mis {alpha['mis t=1']:.3f} / {alpha['mis t=0']:.3f}, "
            f"ali {alpha['ali t=1']:.3f} / {alpha['ali t=0']:.3f} "
            "(the reference's comment: argmax agreement ~0.53 / ~0.91)")
        if not alpha["ali t=0"] > alpha["mis t=0"]:
            raise AssertionError(f"aligned draft no better: {alpha}")
        prompts = SV.make_prompts(4)
        n_new = 32
        greedy = M.greedy_reference(mis[2], mis[3], prompts, n_new)
        ecfg = TP.default_ecfg(
            "misaligned", draft_mode="parallel",
            max_len=SV.auto_max_len(prompts, n_new, 4, 15.0))
        res, rep, counts, wall, _ = drive(
            mis, ecfg, prompts, n_new, dev, hrad_params=mlp,
            draft_heads=heads)
        add_counts(totals, counts)
        sig = signal_hist(res.values())
        log(f"  SpecBranch parallel drafting + trained heads + trained "
            f"H-RAD: rounds={rep['rounds']} dispatches/round="
            f"{rep['dispatches_per_round']:.2f} signals={sig} "
            f"M={np.mean([r.stats.mean_accepted for r in res.values()]):.2f}"
            f" wall={wall:.2f}s")
        bad = [i for i in range(len(prompts)) if res[i].tokens != greedy[i]]
        if bad:
            raise AssertionError(f"trained heads + MLP serve: requests {bad} "
                                 "differ from greedy decoding")
        out = dict(alpha=alpha, seconds=dict(ali=t_ali, heads=t_heads,
                                             hrad=t_hrad), signals=sig,
                   rounds=rep["rounds"])
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    return out


def phase_train_reduced(dev, totals) -> dict:
    """(b) Every assigned config's reduced() (f32): one train step's loss
    and gradients on the card (the flash and scan backward kernels) and
    on the CPU (autograd over the plain versions) from the same params,
    within TRAIN_RTOL / TRAIN_ATOL; every leaf with a gradient on the CPU
    has a non-zero finite one on the card; then the AdamW step on both."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.training import optim as TO
    from repro_torch.training import train as TT
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        params = M.init_params(cfg, 0, "cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(2, 17)))
        cl, _, cg = TT.value_and_grad(TT.lm_loss, params, cfg, toks)
        card = tree_to(params, dev)
        ops.reset_launches()
        gl, _, gg = TT.value_and_grad(TT.lm_loss, card, cfg, toks.to(dev))
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        add_counts(totals, counts)
        err, n_live = 0.0, 0
        for i, (a, b) in enumerate(zip(TO.tree_leaves(gg),
                                       TO.tree_leaves(cg))):
            a = a.cpu()
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{arch} reduced: leaf {i} not finite")
            if bool((b != 0).any()):
                n_live += 1
                if not bool((a != 0).any()):
                    raise AssertionError(f"{arch} reduced: leaf {i} has no "
                                         "gradient on the card")
            d = (a - b).abs()
            if not bool((d <= TRAIN_ATOL + TRAIN_RTOL * b.abs()).all()):
                raise AssertionError(f"{arch} reduced: leaf {i} off by "
                                     f"{d.max().item():.3e}")
            err = max(err, d.max().item())
        lerr = abs(float(gl) - float(cl))
        if lerr > TRAIN_ATOL + TRAIN_RTOL * abs(float(cl)):
            raise AssertionError(f"{arch} reduced: loss {float(gl)} vs "
                                 f"{float(cl)}")
        for tree, grads in ((params, cg), (card, gg)):
            TO.apply(TO.AdamWConfig(), tree, grads, TO.init(tree))
        step_err = max((a.cpu() - b).abs().max().item() for a, b in zip(
            TO.tree_leaves(card), TO.tree_leaves(params)))
        log(f"  {arch} reduced: loss card {float(gl):.5f} cpu "
            f"{float(cl):.5f}; grads max err {err:.2e} over {n_live} live "
            f"leaves; after a step params max err {step_err:.2e}; launches "
            f"flash_bwd {counts['flash_attention_bwd']} scan_bwd "
            f"{counts['ssm_scan_bwd']}")
        out[arch] = dict(loss_err=lerr, grad_err=err, launches=counts)
    return out


def train_full(label, cfg, dev, totals, batch, seq, micro, steps,
               profile: bool = False) -> dict:
    """The port's ``launch.train`` path (``launch.train.run``: the remat,
    gradient-accumulated step and AdamW, random bf16 weights) at full
    width: finite losses; after the first step every leaf's m (0.1 x its
    clipped gradient) non-zero and finite; the backward kernels
    launched; per-step wall time and peak device memory.  ``profile``:
    the CUDA profiler over the second step (from the end of the first
    step's checks to the second step's synchronised loss): the device's
    busy share of that wall time, the top kernels by device time and the
    flash backward's kernels (the step's wall time includes the
    profiler's overhead)."""
    from repro_torch.launch import train as LT
    from repro_torch.training import optim as TO
    checked, prof = {}, {}

    def on_step(i, params, opt_state):
        if i == 0:
            bad = [j for j, m in enumerate(TO.tree_leaves(opt_state.m))
                   if not bool(torch.isfinite(m).all())
                   or not bool((m != 0).any())]
            checked["leaves"] = len(TO.tree_leaves(opt_state.m))
            checked["bad"] = bad
            checked["bytes"] = sum(x.numel() * x.element_size()
                                   for tree in (params, opt_state.m,
                                                opt_state.v)
                                   for x in TO.tree_leaves(tree))
        if profile and i == 0:
            torch.cuda.synchronize()
            prof["p"] = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.time()
            prof["n0"] = ops.LAUNCHES["flash_attention_bwd"]
        elif profile and i == 1:
            torch.cuda.synchronize()
            wall = time.time() - prof["t0"]
            prof["p"].__exit__(None, None, None)
            evs, busy, by_name = device_events(prof["p"])
            bwd = [e.duration_ns() for e in evs if "flash_bwd" in e.name()]
            scan = [e.duration_ns() for e in evs if "ssm_" in e.name()]
            scan_bwd = [e.duration_ns() for e in evs
                        if "ssm_bwd" in e.name()]
            prof["stats"] = dict(
                scan_ms=sum(scan) / 1e6, scan_bwd_ms=sum(scan_bwd) / 1e6,
                scan_kernels=len(scan),
                wall_s=wall, busy_share=busy / 1e9 / wall,
                device_s=sum(by_name.values()) / 1e9,
                top=[(n, t / 1e6) for n, t in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:8]],
                flash_bwd_ms=sum(bwd) / 1e6, flash_bwd_kernels=len(bwd),
                flash_bwd_calls=ops.LAUNCHES["flash_attention_bwd"]
                - prof["n0"])

    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    rep = LT.run(cfg, steps, batch, seq, micro, dev,
                 log=lambda m: log(f"  {label} {m}"), on_step=on_step)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    add_counts(totals, counts)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  {label}: {cfg.num_layers} layers d{cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f}B params, batch {batch} x {seq} "
        f"in {micro} micro-batches: losses {rep['loss']}, step wall "
        f"{[round(t, 2) for t in rep['seconds']]} s, params + m + v "
        f"{checked['bytes'] / 1e9:.1f} GB, peak {peak:.1f} GB; launches "
        f"flash {counts['flash_attention']} flash_bwd "
        f"{counts['flash_attention_bwd']} scan {counts['ssm_scan']} "
        f"scan_bwd {counts['ssm_scan_bwd']}")
    if not all(math.isfinite(x) for x in rep["loss"]):
        raise AssertionError(f"{label}: non-finite loss {rep['loss']}")
    if checked["bad"]:
        raise AssertionError(f"{label}: leaves {checked['bad']} of "
                             f"{checked['leaves']} have a zero or "
                             "non-finite gradient")
    st = prof.get("stats")
    if st is not None:
        log(f"  {label} step 1 profiled: wall {st['wall_s']:.3f} s, device "
            f"busy {st['busy_share']:.3f} of it, device time "
            f"{st['device_s']:.3f} s; flash backward kernels "
            f"{st['flash_bwd_ms']:.1f} ms in {st['flash_bwd_kernels']} "
            f"kernel events over {st['flash_bwd_calls']} calls (a late "
            "profiler session of one process may lose events); the scan's "
            f"kernels {st['scan_ms']:.1f} ms "
            f"({st['scan_ms'] / 1e3 / max(st['device_s'], 1e-9):.3f} of "
            f"device time; backward {st['scan_bwd_ms']:.1f} ms) in "
            f"{st['scan_kernels']} kernel events; top kernels (ms):")
        for n, t in st["top"]:
            log(f"    {t:9.2f}  {n}")
    return dict(loss=rep["loss"], step_s=rep["seconds"], peak_gb=peak,
                state_gb=checked["bytes"] / 1e9, launches=counts,
                profile=st)


def phase_train_gemma3(dev, totals) -> dict:
    """(c) gemma3-4b at full width through the training CLI's path, 3
    steps of 2 x 1281 tokens in 2 micro-batches: each micro-batch is one
    1280-token row, so the local layers' window (1024) masks in the
    backward; the second step profiled."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma3-4b")
    if (cfg.num_layers, cfg.d_model, cfg.sliding_window) != (34, 2560, 1024):
        raise AssertionError(f"gemma3-4b config changed: {cfg}")
    res = train_full("gemma3-4b", cfg, dev, totals, G3_TRAIN["batch"],
                     G3_TRAIN["seq"], G3_TRAIN["micro"], G3_TRAIN["steps"],
                     profile=True)
    if res["launches"]["flash_attention_bwd"] == 0:
        raise AssertionError("gemma3-4b: the flash backward did not run")
    return res


def phase_train_falcon(dev, totals) -> dict:
    """(d) falcon-mamba-7b at full width with its depth cut to 16 of 64
    layers (four bf16 copies of its ~7B parameters, ~56 GB, would leave
    no room for activations): 2 steps of 2 x 257 tokens in 2
    micro-batches, the second profiled (the scan kernels' share)."""
    from repro_torch.configs import get_config
    cfg = get_config("falcon-mamba-7b")
    if (cfg.num_layers, cfg.d_model) != (64, 4096):
        raise AssertionError(f"falcon-mamba-7b config changed: {cfg}")
    cfg = cfg.replace(num_layers=FALCON_TRAIN["layers"])
    res = train_full("falcon-mamba-7b/16", cfg, dev, totals,
                     FALCON_TRAIN["batch"], FALCON_TRAIN["seq"],
                     FALCON_TRAIN["micro"], FALCON_TRAIN["steps"],
                     profile=True)
    if res["launches"]["ssm_scan_bwd"] == 0:
        raise AssertionError("falcon-mamba-7b: the scan backward did not run")
    return res


# ---------------------------------------------------------------------------
# phase 17: mesh-sharded serving
# ---------------------------------------------------------------------------

def mesh_spawn(dims, jobs, devices=None, target="serve:serve_jobs"):
    """``target`` (a rank target of ``repro_torch.launch``, by default
    ``serve.serve_jobs``) with ``jobs`` on every rank of a ``dims`` mesh,
    each rank a fresh process; on the card the ranks share cuda:0 over
    gloo (NCCL takes no two ranks on one GPU).  A failed or silent rank
    raises."""
    n = dims[0] * dims[1]
    return MESH.spawn(*dims, "repro_torch.launch." + target, jobs,
                      backend="gloo", devices=devices or ["cuda:0"] * n,
                      timeout_s=MESH_JOIN_S, threads=2)


def mesh_jobs(pair, prompts, temp, census=True, names=None):
    """Both engines x both backends on ``pair``, 4 x MESH_TINY_NEW."""
    max_len = SV.auto_max_len(prompts, MESH_TINY_NEW, 4, 10.0)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, max_len=max_len)
    return [dict(name=f"{e}-{b}", pair=pair, prompts=prompts,
                 new_tokens=MESH_TINY_NEW, engine=e, attn_backend=b,
                 ecfg=ecfg, max_batch=4, census=census)
            for e in ("sps", "specbranch") for b in ("dense", "paged")
            if names is None or f"{e}-{b}" in names]


def mesh_card_serve(job, dev, memo) -> dict:
    """The same job unmeshed on the card: its streams by rid (``memo``
    keeps each distinct job's, so the meshes that share a job share its
    serve)."""
    key = (id(job["pair"][0]), job["engine"], job["attn_backend"],
           repr(job["ecfg"]), job.get("pool_pages"), len(job["prompts"]),
           job["new_tokens"])
    if key in memo:
        return memo[key]
    dpair = tuple(tree_to(x, dev) if isinstance(x, dict) else x
                  for x in job["pair"])
    res = SV.serve(dpair, job["ecfg"], job["prompts"], job["new_tokens"],
                   device=dev, max_batch=job["max_batch"],
                   page_size=job.get("page_size", 16),
                   pool_pages=job.get("pool_pages"),
                   engine=job["engine"],
                   attn_backend=job["attn_backend"])[0]
    memo[key] = {rid: list(r.tokens) for rid, r in res.items()}
    return memo[key]


def mesh_check(label, ranks, want, totals, kernels) -> None:
    """Every rank's streams equal ``want`` (by rid); the kernels named
    launched on every rank; the ranks' launches join the totals."""
    for i, r in enumerate(ranks):
        if r["tokens"] != want:
            bad = [k for k in want if r["tokens"].get(k) != want[k]]
            raise AssertionError(f"{label}: rank {i} requests {bad} differ")
        if r["pages_in_use"]:
            raise AssertionError(f"{label}: rank {i} leaks pages")
        for k in kernels:
            if r["launches"][k] == 0:
                raise AssertionError(f"{label}: rank {i} launched no {k}")
        for k, v in r["launches"].items():
            totals[k] += v


def mesh_pair62():
    """Phase 17d's tiny random pair: 6 query heads reading 2 KV heads
    (groups of 3), hd 16, target 2 layers, draft 1, f32, CPU trees."""
    from repro_torch.models.config import ModelConfig, dense_pattern
    base = dict(family="dense", pattern=dense_pattern(0), vocab_size=256,
                dtype="float32", num_heads=6, num_kv_heads=2, d_model=96,
                d_ff=384)
    tcfg = ModelConfig(name="mesh62-target", num_layers=2, **base)
    dcfg = ModelConfig(name="mesh62-draft", num_layers=1, **base)
    return (M.init_params(dcfg, 1, "cpu"), dcfg,
            M.init_params(tcfg, 0, "cpu"), tcfg)


def mesh_train_config():
    from repro_torch.configs import get_config
    cfg = get_config("gemma3-4b")
    if (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
            cfg.vocab_size) != (2560, 8, 4, 256, 262144):
        raise AssertionError(f"gemma3-4b config changed: {cfg}")
    cfg = cfg.replace(num_layers=MESH_TRAIN["layers"])
    if [m for m, _ in cfg.pattern] != ["local"] * 5 + ["attn"]:
        raise AssertionError(f"gemma3-4b's first 6 layers: {cfg.pattern}")
    return cfg


def mesh_train_reference(dev, totals) -> dict:
    """Phase 17e's steps in one process on the card; the result is saved
    (CPU, under build/) for the ranks to hold their blocks against."""
    from repro_torch.launch import steps as ST
    from repro_torch.training import optim
    cfg = mesh_train_config()
    rng = np.random.default_rng(17)
    batches = [rng.integers(0, cfg.vocab_size,
                            (MESH_TRAIN["batch"], MESH_TRAIN["seq"]))
               for _ in range(MESH_TRAIN["steps"])]
    ocfg = optim.AdamWConfig(lr=1e-3, total_steps=MESH_TRAIN["steps"])
    free_device_memory()
    params = M.init_params(cfg, 0, dev)
    opt_state = optim.init(params)
    step = ST.make_train_step(cfg, MESH_TRAIN["micro"], ocfg)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    losses, secs = [], []
    for b in batches:
        t0 = time.time()
        params, opt_state, loss = step(params, opt_state,
                                       torch.from_numpy(b).to(dev))
        losses.append(float(loss))
        secs.append(time.time() - t0)
    launches = dict(ops.LAUNCHES)
    add_counts(totals, launches)
    peak = torch.cuda.max_memory_allocated(dev)
    gnorms = [float(g) for g in step.gnorms]
    path = os.path.join(ROOT, "build", "phase17", "train_ref.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(optim.tree_map(lambda t: t.cpu(), params), path)
    del params, opt_state
    free_device_memory()
    return dict(cfg=cfg, batches=batches, ocfg=ocfg, losses=losses,
                gnorms=gnorms, seconds=secs, peak_bytes=peak,
                launches=launches, path=path)


def mesh_train_check(ref, ranks, totals) -> dict:
    """Phase 17e: every rank's losses, global norms and parameter blocks
    against the single process's; peaks, flash launches and the census
    beside the formula.  Everything is printed before it is judged."""
    from repro_torch.launch import steps as ST
    from repro_torch.sharding import hlo_analysis as HA
    from repro_torch.training import optim
    cfg = ref["cfg"]
    m = MESH.ShapeMesh({"data": 2, "model": 2})
    B, T = MESH_TRAIN["batch"], MESH_TRAIN["seq"] - 1
    # AdamW moves a weight by at most about lr a step whatever its
    # gradient, so two runs can drift apart by up to 2 lr a step where a
    # tiny gradient takes the other sign in another summation order
    lrs = sum(optim.schedule(ref["ocfg"], i)
              for i in range(MESH_TRAIN["steps"]))

    def bound(scale):
        return 2.1 * lrs + MESH_TRAIN_ULPS * 2.0 ** -7 * scale
    out = {"losses_single": ref["losses"], "gnorms_single": ref["gnorms"],
           "ranks": []}
    bad = []
    for r, res in enumerate(ranks):
        coords = {"data": r // 2, "model": r % 2}
        dl = max(abs(a - b) for a, b in zip(res["losses"], ref["losses"]))
        dg = max(abs(a - b) / b for a, b in zip(res["gnorms"],
                                                ref["gnorms"]))
        low = min(res["errors"].items(), key=lambda kv: kv[1][2])
        over = [p for p, (err, scale, _) in res["errors"].items()
                if err > bound(scale)]
        cost = ST.step_costs(cfg, "train", B, T, m, coords,
                             n_micro=MESH_TRAIN["micro"])
        want = ST.events_by_key(cost["events"])
        census_ok = all(c == want for c in res["census"])
        got_b = HA.bytes_by_kind((k.rpartition("@")[0],
                                  int(k.rpartition("@")[2]), b)
                                 for k, (_, b) in res["census"][0].items())
        want_b = HA.bytes_by_kind(cost["events"])
        add_counts(totals, res["launches"])
        row = dict(rank=r, losses=res["losses"], loss_gap=dl,
                   gnorms=res["gnorms"], gnorm_rel_gap=dg,
                   lowest_update_cos=(low[0], low[1][2]),
                   over_bound=over, peak_gb=res["peak_bytes"] / 1e9,
                   seconds=res["seconds"],
                   flash_fwd=res["launches"]["flash_attention"],
                   flash_bwd=res["launches"]["flash_attention_bwd"],
                   census_bytes=got_b["total"], census_ok=census_ok,
                   formula_bytes=want_b["total"])
        out["ranks"].append(row)
        log(f"  (e) rank {r}: losses {res['losses']} (single "
            f"{ref['losses']}, gap {dl:.2e}); global norms "
            f"{[round(x, 4) for x in res['gnorms']]} (single "
            f"{[round(x, 4) for x in ref['gnorms']]}, relative gap "
            f"{dg:.2e}); lowest update cosine {low[1][2]:.5f} ({low[0]}); "
            f"leaves over the bound {over}; peak {row['peak_gb']:.2f} GB "
            f"(single process {ref['peak_bytes'] / 1e9:.2f} GB); flash "
            f"fwd / bwd launches {row['flash_fwd']} / {row['flash_bwd']} "
            f"(single process {ref['launches']['flash_attention']} / "
            f"{ref['launches']['flash_attention_bwd']}); census of a step "
            f"{got_b['total'] / 1e9:.4f} GB moved "
            f"({ {k: round(v / 1e6, 3) for k, v in got_b.items() if v} } "
            f"MB), formula {want_b['total'] / 1e9:.4f} GB, equal "
            f"{census_ok}; step seconds "
            f"{[round(x, 2) for x in res['seconds']]} (single process "
            f"{[round(x, 2) for x in ref['seconds']]})")
        if dl > MESH_TRAIN_LOSS_ATOL or dg > MESH_TRAIN_GNORM_RTOL \
                or low[1][2] < MESH_TRAIN_COS or over or not census_ok:
            bad.append(r)
        for k in ("flash_attention", "flash_attention_bwd"):
            if res["launches"][k] == 0:
                bad.append(f"rank {r} launched no {k}")
    if bad:
        raise AssertionError(f"mesh 2x2 train: ranks {bad} outside the "
                             "bf16 tolerance (see the lines above)")
    return out


def expected_forward_census(tcfg, backend, dims) -> dict:
    """The collectives one target verify forward of a dense-MLP target
    issues on a ``dims`` mesh, by ``kind@n`` (``models.model``: one
    all-reduce after wo and one after wd a layer, one for a
    vocabulary-split embedding, one all-gather of vocabulary-split logits;
    the dense backend at dp > 1 gathers the rows' logits over "data")."""
    dp, tp = dims
    out = {}
    if tp > 1:
        split_v = int(tcfg.vocab_size % tp == 0)
        out[f"all-reduce@{tp}"] = 2 * tcfg.num_layers + split_v
        if split_v:
            out[f"all-gather@{tp}"] = 1
    if backend == "dense" and dp > 1:
        out[f"all-gather@{dp}"] = out.get(f"all-gather@{dp}", 0) + 1
    return out


def phase_mesh(dev, totals, phase4=None) -> dict:
    """Phase 17: mesh-sharded serving (see the module docstring)."""
    from repro_torch.training.pairs import get_pair
    log_phase("[17] mesh: ranks in fresh processes sharing cuda:0 over "
              "gloo (correctness only: their times say nothing of NVLink "
              "or of tensor-parallel speed)")
    free_device_memory()
    t0 = time.time()
    out = {}
    cpu = get_pair("misaligned", device="cpu",
                   cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    prompts = SV.make_prompts(4)
    by = {}
    # (a) the collective probe, (b) the tiny pair at 1x1, 1x2, 2x2 and the
    # jamba-shaped pair at 1x2, (c) LLaMA-68M/7B at 1x2: one spawn a mesh
    jamba = SV.load_pair("jamba-shaped", "cpu")
    jmax = SV.auto_max_len(prompts, MESH_TINY_NEW, 4, 10.0)
    extra12 = [
        dict(name="specbranch-paged temp1", pair=cpu, prompts=prompts,
             new_tokens=MESH_TINY_NEW, engine="specbranch",
             attn_backend="paged", max_batch=4,
             ecfg=EngineConfig(gamma=4, c=10.0, temperature=1.0,
                               epsilon=0.0, max_len=jmax)),
        dict(name="sps-paged preempt", pair=cpu, prompts=prompts,
             new_tokens=MESH_TINY_NEW, engine="sps", attn_backend="paged",
             max_batch=4, page_size=4, pool_pages=MESH_PREEMPT_POOL,
             ecfg=EngineConfig(gamma=4, c=10.0, max_len=jmax)),
        dict(name="jamba", pair=jamba, prompts=prompts[:2],
             new_tokens=MESH_TINY_NEW, engine="specbranch",
             attn_backend="paged", max_batch=2,
             ecfg=EngineConfig(gamma=4, c=10.0, max_len=jmax))]
    full_prompts = SV.make_prompts(MESH_FULL_ROWS)
    full = dict(name="llama-7b", pair_kind=MESH_FULL_PAIR,
                prompts=full_prompts, new_tokens=FULL_NEW,
                engine="specbranch", attn_backend="paged", max_batch=8,
                ecfg=EngineConfig(gamma=4, c=10.0, max_len=SV.auto_max_len(
                    full_prompts, FULL_NEW, 4, 10.0)))
    pair62 = mesh_pair62()              # vocabulary 256 > the prompts' 199
    plan = {(1, 1): mesh_jobs(cpu, prompts, 1.0),
            (1, 2): mesh_jobs(cpu, prompts, 0.0) + extra12,
            (2, 2): mesh_jobs(cpu, prompts, 0.0),
            (1, 3): mesh_jobs(pair62, prompts, 0.0, census=False,
                              names={"specbranch-dense",
                                     "specbranch-paged"})}
    # (e) the training mesh's single-process reference, before the ranks
    t1 = time.time()
    train_ref = mesh_train_reference(dev, totals)
    log(f"  (e) gemma3-4b/{MESH_TRAIN['layers']} single process on the "
        f"card: losses {train_ref['losses']}, peak "
        f"{train_ref['peak_bytes'] / 1e9:.2f} GB, step seconds "
        f"{[round(x, 2) for x in train_ref['seconds']]} "
        f"({time.time() - t1:.1f}s with the save)")
    train_job = dict(name="gemma3-4b/6 2x2", cfg=train_ref["cfg"],
                     n_micro=MESH_TRAIN["micro"], seed=0,
                     batches=train_ref["batches"], ocfg=train_ref["ocfg"],
                     compare_to=train_ref["path"])
    # the meshes' spawns (the 7B drive and the probe 1x2 spawns of their
    # own) run at once
    spawns = {dims: (mesh_spawn, dims, jobs) for dims, jobs in plan.items()}
    spawns[("7B", 1, 2)] = (mesh_spawn, (1, 2), [full])
    spawns[("probe", 1, 2)] = (mesh_spawn, (1, 2), None, None,
                               "mesh:probe_collectives")
    spawns[("train", 2, 2)] = (mesh_spawn, (2, 2), [train_job], None,
                               "train:train_jobs")

    def timed(fn, *a):
        t1 = time.time()
        return fn(*a), time.time() - t1
    with concurrent.futures.ThreadPoolExecutor(len(spawns)) as pool:
        futs = {k: pool.submit(timed, *v) for k, v in spawns.items()}
        done = {k: f.result() for k, f in futs.items()}
    for key, (ranks, secs) in done.items():
        what = {"7B": "7B spawn",
                "probe": "probe spawn",
                "train": "training spawn"}.get(key[0], "spawn")
        log(f"  {key[-2]}x{key[-1]} {what}: {len(ranks)} ranks, "
            f"{secs:.1f}s (concurrent)")
        if key[0] == "probe":
            probe = ranks[0]
            continue
        if key[0] == "7B":
            full_ranks = [rank[0] for rank in ranks]
            continue
        if key[0] == "train":
            train_ranks = [rank[0] for rank in ranks]
            continue
        by[key] = {}
        for rank in ranks:
            for r in rank:
                by[key].setdefault(r["name"], []).append(r)
    log(f"  (a) gloo on CUDA tensors, torch {torch.__version__}: "
        + ", ".join(f"{k} {v}" for k, v in probe.items()))
    out["probe"] = probe
    for k in ("all_reduce float32", "all_gather float32",
              "broadcast float32", "all_reduce bfloat16",
              "all_gather bfloat16", "reduce_scatter bfloat16",
              "reduce_scatter float32"):
        if probe[k] != "ok":
            raise AssertionError(f"gloo on CUDA: {k}: {probe[k]}")
    kern = {"dense": ["flash_attention"], "paged": ["paged_attention"]}
    memo = {}
    for dims, jobs in plan.items():
        for job in jobs:
            name = job["name"]
            ranks = by[dims][name]
            label = f"mesh {dims[0]}x{dims[1]} {name}"
            # temperature 1 on a larger mesh is greedy-lossless only: its
            # ranks must agree (debug_check compares them every round)
            want = (ranks[0]["tokens"] if name == "specbranch-paged temp1"
                    else mesh_card_serve(job, dev, memo))
            ks = list(kern[job["attn_backend"]])
            if job["ecfg"].temperature > 0:
                ks.append("verify_accept_batched")
            if name.endswith("preempt"):
                ks.append("paged_gather")
            if name == "jamba":
                ks.append("ssm_scan_ring")
            mesh_check(label, ranks, want, totals, ks)
            r = ranks[0]
            line = (f"  {label}: rounds={r['rounds']} "
                    f"wall={r['wall']:.2f}s collectives={r['collectives']}")
            if "census" in r:
                line += f" forward census={r['census']}"
                want_c = expected_forward_census(job["pair"][3],
                                                 job["attn_backend"], dims)
                if r["census"]["forward"] != want_c:
                    raise AssertionError(f"{label}: census {r['census']} "
                                         f"!= {want_c}")
                if dims == (1, 1) and (r["census"]["forward"]
                                       or r["collectives"]):
                    raise AssertionError(f"{label}: a 1x1 mesh issued "
                                         "collectives")
            log(line + f" launches={r['launches']}")
            out[label] = dict(rounds=r["rounds"], wall_s=r["wall"],
                              collectives=r["collectives"],
                              census=r.get("census"),
                              launches=[x["launches"] for x in ranks])
    # (c) LLaMA-68M/7B at 1x2, teacher-forced against the single-device
    # forward on one card
    ranks = full_ranks
    r0 = ranks[0]
    for i, r in enumerate(ranks):
        if r["tokens"] != r0["tokens"]:
            raise AssertionError(f"mesh 1x2 llama-7b: rank {i} differs")
        for k in ("paged_attention",):
            if r["launches"][k] == 0:
                raise AssertionError(f"mesh 1x2 llama-7b: rank {i} "
                                     f"launched no {k}")
        for k, v in r["launches"].items():
            totals[k] += v
    free_device_memory()
    pair = SV.load_pair(MESH_FULL_PAIR, dev)
    res = {rid: types.SimpleNamespace(tokens=t)
           for rid, t in r0["tokens"].items()}
    tf = teacher_forced(pair[2], pair[3], full_prompts, res, FULL_NEW)
    del pair
    free_device_memory()
    peaks = [r["peak_bytes"] / 1e9 for r in ranks]
    p4 = (phase4 or {}).get("greedy", {}).get("peak_gb")
    tps = r0["total_tokens"] / max(r0["wall"], 1e-9)
    log(f"  (c) mesh 1x2 llama-7b SpecBranch paged greedy {MESH_FULL_ROWS} "
        f"x {FULL_NEW}: "
        f"{tps:.1f} tok/s wall (two ranks time-sharing one card through "
        f"gloo: not a tensor-parallel speed), rounds={r0['rounds']}, "
        f"collectives={r0['collectives']}; peak allocated per rank "
        f"{', '.join(f'{x:.2f}' for x in peaks)} GB beside phase 4's "
        f"{p4 if p4 is None else round(p4, 2)} GB on one card; "
        f"launches={r0['launches']}")
    out["llama-7b 1x2"] = dict(tokens_per_s=tps, wall_s=r0["wall"],
                               rounds=r0["rounds"], peak_gb=peaks,
                               phase4_peak_gb=p4, teacher_forced=tf,
                               collectives=r0["collectives"])
    # (e) the FSDP x TP training mesh at 2x2
    out["train 2x2"] = mesh_train_check(train_ref, train_ranks, totals)
    os.remove(train_ref["path"])
    log(f"  phase 17: {time.time() - t0:.1f}s")
    return out


def log_ptxas(ptx: str) -> None:
    """Registers and spills of every kernel the build compiled, from
    ``nvcc -Xptxas -v``; the decode loop's variants (decode, and flash's
    wide block) by addressing struct, dtype, head dim and ring stages,
    the scan's by N, x dtype and entry (carry, states, ring, chunks), the
    scan backward's by kernel, N and x dtype, the
    verify's by entry and logit dtype, the flash backward's by kernel,
    head dim and dtype."""
    name, spill = "?", ""
    for ln in ptx.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            m = re.search(r"(decode|wide)_attention_kernelI(\w+?)Li(\d+)E"
                          r"Li(\d+)ENS_\d+(\w+?)Keys(?:ELb([01]))?", name)
            if m:
                dt = "bf16" if "bfloat" in m.group(2) else "f32"
                name = (f"{m.group(1)} {m.group(5)}Keys {dt} "
                        f"hd={m.group(3)} stages={m.group(4)}"
                        + (" ragged" if m.group(6) == "1" else ""))
            m = re.search(r"ssm_scan_kernelILi(\d+)E(13__nv_bfloat16|f)"
                          r"Li(\d)E", name)
            if m:
                dt = "bf16" if "bfloat" in m.group(2) else "f32"
                mode = ("carry", "states", "ring", "chunks")[
                    int(m.group(3))]
                name = f"ssm_scan N={m.group(1)} x {dt} {mode}"
            m = re.search(r"(flash_bwd_(?:dq_mma|dkdv_mma|dq_tf32|dkdv_tf32"
                          r"|dq_merge|dkdv_reduce|rows|spans|prep|final)"
                          r"_kernel)(?:I(?:Li(\d+)E)?(?:Lb([01])E)?)?", name)
            if m:
                name = (m.group(1) + (f" hd={m.group(2)}" if m.group(2)
                                      else "")
                        + (" f32" if "ArgsTIfE" in name else " bf16")
                        + (" ragged" if m.group(3) == "1" else ""))
            m = re.search(r"(ssm_bwd_(?:local|join|main|reduce)_kernel)"
                          r"(?:ILi(\d+)E(13__nv_bfloat16|f)?)?", name)
            if m:
                name = (m.group(1) + (f" N={m.group(2)}" if m.group(2)
                                      else "")
                        + ({"f": " x f32", None: ""}.get(m.group(3),
                                                          " x bf16")))
            m = re.search(r"verify_accept_(batched_)?kernel(I13__nv_bfloat16"
                          r"|If)?E", name)
            if m:
                name = ("verify batched f32" if m.group(1) else
                        "verify single " + ("bf16" if "bfloat"
                                            in (m.group(2) or "") else "f32"))
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            log(f"  ptxas {name[:60]:60s} {regs:>3s} regs; {spill}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t0 = time.time()
    build.lib()
    log_phase(f"[1] build: {build.BUILD_INFO.get('seconds', 0.0):.1f}s "
              f"({time.time() - t0:.1f}s with load); card: {smi}")
    log("  nvcc per source (s from the build's start): "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
            build.BUILD_INFO.get("per_source", {}).items(),
            key=lambda kv: -kv[1])))
    log_ptxas(str(build.BUILD_INFO.get("ptxas", "")))
    if "--profile" in sys.argv[1:]:
        log(f"[profile] phase 4's profiled serve, port from {SRC}")
        phase_profile(dev)
        return 3                # a profile run gives no smoke result
    if "--scan" in sys.argv[1:]:
        log(f"[scan] the plain scan's cases, port from {SRC}")
        phase_scan()
        return 3                # a scan run gives no smoke result
    if "--flash-bwd" in sys.argv[1:]:
        log(f"[flash-bwd] phase 2's flash backward cases, port from {SRC}")
        phase_flash_bwd()
        return 3                # no smoke result
    if "--scan-bwd" in sys.argv[1:]:
        log(f"[scan-bwd] phase 2's scan backward cases, port from {SRC}")
        phase_scan_bwd()
        return 3                # no smoke result
    if "--attn" in sys.argv[1:]:
        log(f"[attn] phase 2's aligned attention cases, port from {SRC}")
        phase_attn()
        return 3                # no smoke result
    if "--probe" in sys.argv[1:]:
        log("[probe] attention tile loop phase by phase")
        phase_probe()
        return 3                # a probe run gives no smoke result
    if "--trace-modes" in sys.argv[1:]:
        log("[trace-modes] the 7B SpecBranch serve traced in both draft "
            "modes")
        phase_trace_modes(dev, sys.argv[sys.argv.index("--trace-modes")
                                        + 1])
        return 3                # a child of phase 13: no smoke result
    log_phase("[2] kernels vs plain versions")
    cases = phase_kernels()
    totals = {k: 0 for k in KERNELS}
    phase_kernel_api(cases, totals)
    if "--kernels" in sys.argv[1:]:
        return 3                # phases 1-2 only: no smoke result
    if "--prefix" in sys.argv[1:]:
        phase_prefix(dev, totals, SV.load_pair("paper-llama", dev))
        return 3                # phases 1-2 and 14 only: no smoke result
    if "--arch" in sys.argv[1:]:
        phase_arch(dev, totals)
        return 3                # phases 1-2 and 15 only: no smoke result
    if "--train" in sys.argv[1:]:
        phase_train(dev, totals)
        return 3                # phases 1-2 and 16 only: no smoke result
    if "--mesh" in sys.argv[1:]:
        phase_mesh(dev, totals)
        return 3                # phases 1-2 and 17 only: no smoke result
    log_phase("[3] tiny committed pair, f32")
    tiny = phase_tiny(dev, totals)
    log_phase("[4] full-width LLaMA-68M/7B pair, bf16, random weights")
    pair = SV.load_pair("paper-llama", dev)
    without = {"batched": phase_full(dev, totals, pair)}
    log_phase("[5] sequential engines, tiny committed pair, f32")
    phase_seq_tiny(dev, totals)
    log_phase("[6] sequential engines, full-width LLaMA-68M/7B pair, "
              "bf16")
    without["seq"] = phase_seq_full(dev, totals, pair)
    del pair
    log_phase("[7] SSM and hybrid tiny pairs (falcon-shaped, "
              "jamba-shaped), f32")
    phase_hybrid(dev, totals)
    log_phase("[8] full-width falcon-mamba-7b with its draft, bf16, "
              "random weights")
    phase_falcon(dev, totals)
    log_phase(f"[9] H-RAD (init seed {HRAD_SEED}) and batched SpS, tiny "
              "committed pair, f32")
    phase_hrad_tiny(dev, totals)
    log_phase("[10] H-RAD and batched SpS, full-width LLaMA-68M/7B pair, "
              "bf16")
    free_device_memory()
    pair = SV.load_pair("paper-llama", dev)
    phase_hrad_full(dev, totals, pair, without)
    log_phase("[11] dense backend: tiny committed and jamba-shaped pairs "
              "(f32), full-width LLaMA-68M/7B (bf16)")
    free_device_memory()
    phase_dense_tiny(dev, totals, tiny["served"])
    phase_dense_full(dev, totals, pair, without["batched"]["profile"])
    log_phase("[12] trace recorder: full-width LLaMA-68M/7B batched "
              "SpecBranch, untraced and traced under the CUDA profiler "
              "(a fresh process; its parallel-draft serve is phase 13's)")
    free_device_memory()
    traced = traced_modes_in_child(totals)
    log_phase("[13] parallel drafting and the history predictor: tiny "
              "committed pair (f32), full-width LLaMA-68M/7B (bf16)")
    free_device_memory()
    phase_parallel_tiny(dev, totals)
    free_device_memory()
    phase_parallel_full(dev, totals, pair, traced)
    phase_prefix(dev, totals, pair)
    del pair
    phase_arch(dev, totals)
    phase_train(dev, totals)
    phase_mesh(dev, totals, without["batched"])
    for k, v in totals.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 "main path")
    # one line per kernel: the main path's representative shape
    rep_case = {"paged_attention": "llama-7b B=8 T=8",
                "verify_accept_batched": "llama V=32000 B=8 R=16",
                "paged_gather": "zm swap ps=4 dim=512",
                "flash_attention": "llama-7b B=1 T=5 S=512",
                "ssm_scan": SEQ_CARRY_CASE,
                "ssm_scan_ring": FALCON_RING_CASE,
                "branch_decode_attention": "llama-7b k=6 Sp=504 Ss=8",
                "verify_accept": "llama V=32000 R=9",
                "flash_attention_bwd": FLASH_BWD_CASE,
                "ssm_scan_bwd": SCAN_BWD_CASE}
    table = []
    for name, meta in KERNELS.items():
        c = next(r for r in cases[name] if r["case"] == rep_case[name])
        table.append(dict(name=name, **meta, launches=totals[name],
                          max_abs_err=c["max_abs_err"], ms=c["ms"],
                          plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                          bound_by=c["bound_by"],
                          library_ms=c["library_ms"], case=c["case"]))
    log_phase("done")
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
