"""Head dims 1-256 in the port: the width and load path of the attention
kernels (``kernels.decode_attention.head_dim_path``), the flash
backward's plan at a ragged width, and granite-moe-3b-a800m's draft()
(3 heads of hd 85, the one head dim of the repo's configs off the
aligned path) against the reference on the CPU: its forward, and a
sequential SpecBranch greedy serve whose draft is that draft() and whose
target is the same config at 4 layers, both f32.  (The CUDA kernels at
hd 85 against their plain versions: ``test_torch_cuda.py``.)

At an odd head dim the reference's rotate-half RoPE
(``repro.models.layers.apply_rope``) raises: it splits 85 columns into
halves of 42 and 43.  The port rotates the first 84 and passes the last
through (``repro_torch.models.layers.apply_rope``); the granite fixture
runs the reference with that rule in place of its own (``_odd_rope``,
patched for the fixture's duration), so the rest of the reference --
attention, MoE, runners, engine -- holds the port.

Tolerances: logits f32 atol 1e-4 (the reference's arch-model test's: the
same math in another summation order through two layers and an MoE);
streams, GenStats and timelines equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.runtime import engines as JE
from repro.runtime.specbranch import SpecBranchEngine as JSpecBranch
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as TSV
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import engines as TE
from repro_torch.runtime import prng
from repro_torch.runtime import runner as TR
from repro_torch.runtime.specbranch import SpecBranchEngine as TSpecBranch
from repro_torch.training.checkpoint import from_numpy_params

# One intra-op thread: the test workers share the machine's cores.
torch.set_num_threads(1)

ATOL = 1e-4
N_NEW = 12
PROMPT = TSV.make_prompts(1)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_path_over_every_head_dim(dtype):
    """Every head dim from 1 to 256 runs: one of ``HEAD_DIMS`` over
    16-byte aligned rows at its own width on the aligned path, any other
    at the smallest ragged width not below it."""
    for hd in range(1, tda.MAX_HEAD_DIM + 1):
        x = torch.zeros(2, 3, hd, dtype=dtype)
        width, ragged = tda.head_dim_path("attention", hd, x, x)
        if hd in tda.HEAD_DIMS:
            assert (width, ragged) == (hd, False), hd
        else:
            assert ragged and width == min(
                w for w in tda.RAGGED_WIDTHS if w >= hd), hd
        assert hd <= width <= tda.MAX_HEAD_DIM


@pytest.mark.parametrize("dtype,offset", [
    (torch.bfloat16, 1), (torch.bfloat16, 4), (torch.bfloat16, 7),
    (torch.float32, 1), (torch.float32, 2), (torch.float32, 3)])
@pytest.mark.parametrize("hd,width", [(64, 64), (80, 96), (144, 160),
                                      (256, 256)])
def test_head_dim_path_off_a_16_byte_boundary(dtype, offset, hd, width):
    """An aligned head dim whose storage starts off a 16-byte boundary
    (here ``offset`` elements into an allocation) takes the ragged path
    at the smallest ragged width not below it; any one such tensor of a
    call is enough."""
    flat = torch.zeros(4 * hd + 8, dtype=dtype)
    k = flat[offset:offset + 4 * hd].view(1, 4, 1, hd)
    ok = torch.zeros(1, 4, 1, hd, dtype=dtype)
    assert tda.head_dim_path("attention", hd, ok, ok) == (hd, False)
    assert tda.head_dim_path("attention", hd, ok, k) == (width, True)


@pytest.mark.parametrize("hd", [0, -1, 257, 512])
def test_head_dims_outside_1_to_256_are_refused(hd):
    with pytest.raises(ValueError, match="outside 1-256"):
        tda.check_head_dim("flash_attention", hd)
    with pytest.raises(ValueError, match="outside 1-256"):
        tda.head_dim_path("flash_attention", hd, torch.zeros(4))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_plan_at_the_granite_draft_width(dtype):
    """The backward at granite-moe's draft training frame (B=1, T=S=256,
    3 heads of 85) plans at the compiled width 96, as the C entry lays
    out its scratch: the chunks' dq, dk and dv rows hold 96 columns, and
    the dk/dv reduction's float4 columns cover all 96 (floor division
    at 85 would drop the tail).  bf16 takes 64-row and 32-key blocks, f32
    16-row and 16-key blocks (one warp each)."""
    width, ragged = tda.head_dim_path(
        "flash_attention_bwd", 85, torch.zeros(1, 256, 3, 85, dtype=dtype))
    assert (width, ragged) == (96, True)
    plan = tfa.bwd_plan(1, 256, 256, 3, 3, width, dtype)
    n_cq, n_ck = plan["chunks"]["dq"], plan["chunks"]["dkdv"]
    rows, keys = (64, 32) if dtype == torch.bfloat16 else (16, 16)
    q_rows = n_cq * 3 * (256 // rows) * rows
    assert plan["work"] == (4 * 3 * 256 + q_rows * (2 + 96)
                            + n_ck * 2 * 256 * 3 * 96)
    assert plan["blocks"]["dq"] == 3 * (256 // rows) * n_cq
    assert plan["blocks"]["dkdv"] == 3 * (256 // keys) * n_ck
    if dtype == torch.float32:
        assert (n_cq, n_ck) == (16, 16)
    reduce = -(-256 * 3 * 96 // 4 // 128)
    assert reduce * 128 * 4 >= 256 * 3 * 96
    assert (plan["blocks"]["dkdv_reduce"] if dtype == torch.bfloat16 else
            plan["blocks"]["final"] - 3 * 256 // 4) == reduce


def _odd_rope(x, sin, cos):
    """The reference's ``apply_rope`` with the port's rule at an odd head
    dim (the last column unrotated); at an even one the same ops."""
    dt = x.dtype
    x = x.astype(jnp.float32)
    half = sin.shape[-1]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    s, c = sin[..., None, :], cos[..., None, :]
    return jnp.concatenate([x1 * c - x2 * s, x1 * s + x2 * c,
                            x[..., 2 * half:]], axis=-1).astype(dt)


def test_odd_rope_rule_at_even_head_dims_is_the_references():
    from repro.models import layers as JL
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 64)).astype(np.float32)
    sin, cos = JL.rope_sin_cos(jnp.arange(5)[None].repeat(2, 0), 64, 1e4)
    np.testing.assert_array_equal(np.asarray(_odd_rope(x, sin, cos)),
                                  np.asarray(JL.apply_rope(x, sin, cos)))


def _granite_draft_pair():
    """granite-moe-3b-a800m's draft() (2 layers, d 256, 3 heads of 85, 4
    experts top-2), f32, and the same config at 4 layers as the target:
    the reference's weights (keys 1 and 0) and the port's copies."""
    jd = j_get_config("granite-moe-3b-a800m").draft().replace(dtype="float32")
    jt = jd.replace(name=jd.name + "-4l", num_layers=4)
    jdp = JM.init_params(jax.random.PRNGKey(1), jd)
    jtp = JM.init_params(jax.random.PRNGKey(0), jt)

    def port(jcfg, jparams):
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
        return from_numpy_params(jax.tree.map(np.asarray, jparams), cfg,
                                 "cpu"), cfg
    dp, dcfg = port(jd, jdp)
    tp, tcfg = port(jt, jtp)
    return (jdp, jd, jtp, jt), (dp, dcfg, tp, tcfg)


TOKENS = np.random.default_rng(4).integers(0, 49155, size=(2, 11)).astype(
    np.int32)


@pytest.fixture(scope="module")
def granite():
    """The pair; the reference draft's logits over TOKENS; one sequential
    SpecBranch greedy serve in each package (the reference compiles its
    runners per request: one reference engine run).  The reference runs
    with ``_odd_rope``."""
    from repro.models import layers as JL
    jpair, tpair = _granite_draft_pair()
    assert (tpair[1].hd, tpair[1].num_heads, tpair[1].d_model) == (85, 3, 256)
    kw = dict(gamma=4, c=10.0, temperature=0.0, max_len=128)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "apply_rope", _odd_rope)
        jl = np.asarray(JM.forward(jpair[0], jpair[1],
                                   jnp.asarray(TOKENS))[0])
        j = JSpecBranch(*jpair, JE.EngineConfig(**kw)).generate(
            PROMPT, N_NEW, jax.random.PRNGKey(0))
    t = TSpecBranch(*tpair, TE.EngineConfig(**kw)).generate(
        PROMPT, N_NEW, prng.PRNGKey(0))
    return jpair, tpair, jl, j, t


def test_reference_rope_raises_at_an_odd_head_dim():
    """Why the fixture patches the reference: its rotate-half RoPE has no
    value at hd 85."""
    from repro.models import layers as JL
    sin, cos = JL.rope_sin_cos(jnp.arange(3)[None], 85, 1e4)
    with pytest.raises(TypeError):
        JL.apply_rope(jnp.zeros((1, 3, 3, 85)), sin, cos)


def test_granite_draft_forward_matches_reference(granite):
    _, (dp, dcfg, _, _), jl, _, _ = granite
    tl, _ = TM.forward(dp, dcfg, torch.from_numpy(TOKENS).long())
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=ATOL)


def test_granite_draft_specbranch_equals_reference(granite):
    *_, j, t = granite
    assert t.tokens == j.tokens
    assert vars(t.stats) == vars(j.stats)
    assert t.timeline == j.timeline


def test_granite_draft_specbranch_is_greedy_lossless(granite):
    _, (_, _, tp, tcfg), _, _, t = granite
    assert t.tokens == TR.greedy_reference(tp, tcfg, PROMPT, N_NEW,
                                           max_len=128)
