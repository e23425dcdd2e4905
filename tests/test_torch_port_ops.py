"""The PyTorch port's ops against the JAX package's.

The plain versions of the port's two kernels are held against the Pallas
kernels they stand in for, run in interpret mode on the CPU exactly as
``test_pallas_flash.py`` and ``test_pallas_paged.py`` run them. Inputs are
seeded numpy arrays handed to both frameworks. Tolerance: fp32 within 2e-5
max-abs (accumulation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.models import layers as jlayers
from pretraining_llm_tpu.ops.attention import naive_attention as jax_naive_attention
from pretraining_llm_tpu.ops import pallas_flash
from pretraining_llm_tpu.ops.pallas_paged import paged_decode_attention as jax_paged
from pretraining_llm_tpu_torch.models import layers
from pretraining_llm_tpu_torch.ops import _build, cuda_flash, cuda_paged
from pretraining_llm_tpu_torch.ops.attention import naive_attention
from pretraining_llm_tpu_torch.ops.flash_attention import flash_attention

TOL = 2e-5


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize(
    "g,window,t", [(4, 0, 64), (2, 16, 80), (1, 0, 80), (4, 16, 80), (2, 0, 64), (1, 16, 64)]
)
def test_flash_plain_version_matches_pallas(g, window, t):
    """O against ``pallas_flash_attention`` and the logsumexp against
    ``pallas_flash._fwd``; T=80 is not a multiple of 64, and 16-wide
    Pallas blocks exercise its causal/window block skipping."""
    rng = np.random.default_rng(g * 100 + window + t)
    b, h, d = 2, 4, 16
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, g, d)).astype(np.float32)
    v = rng.normal(size=(b, t, g, d)).astype(np.float32)
    want = pallas_flash.pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=16, block_kv=16, window=window, interpret=True,
    )
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), window=window)
    assert got.shape == (b, t, h, d)
    assert _err(want, got) <= TOL

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(-1, t, d)

    _, want_lse = pallas_flash._fwd(
        jnp.asarray(fold(q)), jnp.asarray(fold(k)), jnp.asarray(fold(v)), h, g,
        causal=True, block_q=16, block_kv=16, interpret=True, window=window,
    )
    _, lse = cuda_flash.flash_attention_fwd(
        torch.from_numpy(fold(q)), torch.from_numpy(fold(k)), torch.from_numpy(fold(v)),
        h, g, window=window,
    )
    assert lse.shape == (b * h, t)
    assert _err(np.asarray(want_lse)[..., 0], lse) <= TOL


@pytest.mark.parametrize(
    "t,d,g,window,seg", [(200, 128, 1, 0, False), (264, 32, 1, 200, True), (136, 64, 2, 100, True)]
)
def test_flash_plain_version_matches_pallas_at_tile_edges(t, d, g, window, seg):
    """The tensor-core kernel's edges, scaled down: T not a multiple of its
    64-row tiles (200, 264, 136), Dh 128 and 32, n_rep 4, a window that
    cuts, with and without document segments. O and the logsumexp against
    ``pallas_flash._fwd`` in interpret mode."""
    rng = np.random.default_rng(t + d + window)
    b, h = 2, 4
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, g, d)).astype(np.float32)
    v = rng.normal(size=(b, t, g, d)).astype(np.float32)
    segments = None
    if seg:  # documents of 1 to 60 tokens, as the exclusive cumsum of separators
        segments = np.cumsum(rng.random((b, t)) < 0.05, axis=1).astype(np.int32)

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(-1, t, d)

    blocks = {200: 40, 264: 24, 136: 34}[t]
    want_o, want_lse = pallas_flash._fwd(
        jnp.asarray(fold(q)), jnp.asarray(fold(k)), jnp.asarray(fold(v)), h, g, causal=True,
        block_q=blocks, block_kv=blocks, interpret=True, window=window,
        segments=None if segments is None else jnp.asarray(segments),
    )
    o, lse = cuda_flash.flash_attention_fwd(
        torch.from_numpy(fold(q)), torch.from_numpy(fold(k)), torch.from_numpy(fold(v)), h, g,
        window=window, segments=None if segments is None else torch.from_numpy(segments),
    )
    assert _err(want_o, o) <= TOL
    assert _err(np.asarray(want_lse)[..., 0], lse) <= TOL


@pytest.mark.parametrize("d", [32, 64, 128])
def test_kernel_route_by_dtype(d):
    """A CUDA call of K1 or dK/dV runs the tensor-core kernels for bf16 and
    the CUDA-core kernels for fp32, at every head dim the kernels take;
    any other dtype or head dim raises."""
    assert cuda_flash.kernel_route(torch.bfloat16, d) == "wgmma"
    assert cuda_flash.kernel_route(torch.float32, d) == "fp32"
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_flash.kernel_route(torch.float16, d)
    with pytest.raises(ValueError, match="head dim"):
        cuda_flash.kernel_route(torch.bfloat16, d + 16)


def test_tensor_core_route_needs_16_byte_aligned_operands():
    """TMA reads each operand from a 16-byte aligned address: the wrappers
    hand the kernel a contiguous view that starts 2 bytes into its storage
    as a fresh aligned copy with the same values (``_build.aligned``), and
    an aligned operand as it is."""
    base = torch.arange(1 + 4 * 64 * 32, dtype=torch.bfloat16)
    aligned = base[: 4 * 64 * 32].view(4, 64, 32)
    shifted = base[1:].view(4, 64, 32)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    assert _build.aligned(aligned) is aligned
    copy = _build.aligned(shifted)
    assert copy is not shifted and copy.data_ptr() % 16 == 0 and copy.is_contiguous()
    assert torch.equal(copy, shifted)


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 1), (torch.bfloat16, 8), (torch.float32, 1),
                                          (torch.float32, 4), (torch.int8, 3), (torch.int8, 16)])
def test_alignment_helper_copies_only_misaligned(dtype, offset):
    """A view ``offset`` elements into a fresh buffer is copied exactly when
    it does not start on a 16-byte boundary (bf16 8, fp32 4 and int8 16
    elements are 16 bytes); the copy holds the same values."""
    base = torch.arange(offset + 256).to(dtype)
    view = base[offset:].view(16, 16)
    got = _build.aligned(view)
    assert (got is view) == (view.data_ptr() % 16 == 0) == (offset * base.element_size() % 16 == 0)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)


def test_flash_wrapper_validates_shapes():
    q = torch.zeros(8, 16, 16)
    with pytest.raises(ValueError, match="fold"):
        cuda_flash.flash_attention_fwd(q, torch.zeros(3, 16, 16), torch.zeros(3, 16, 16), 4, 2)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))


def _paged_state(rng, b, n_blocks, max_blocks, bs, t):
    """Fragmented tables with dead tails; row 0 has seq 0."""
    perm = rng.permutation(np.arange(1, n_blocks)).tolist()
    tables = np.zeros((b, max_blocks), np.int32)
    seq = np.zeros((b,), np.int32)
    for i in range(b):
        n_pages = int(rng.integers(1, max_blocks + 1))
        tables[i, :n_pages] = [perm.pop() for _ in range(n_pages)]
        seq[i] = 0 if i == 0 else int(rng.integers(0, n_pages * bs - t + 1))
    return tables, seq


@pytest.mark.parametrize("g,t,window", [(8, 1, 0), (2, 1, 0), (4, 1, 12), (2, 3, 0), (4, 3, 12), (1, 3, 0)])
def test_paged_plain_version_matches_pallas(g, t, window):
    rng = np.random.default_rng(g * 31 + t + window)
    b, h, d, bs, n_blocks, max_blocks = 4, 8, 16, 8, 24, 5
    shape_q = (b, t, h, d) if t > 1 else (b, h, d)
    q = rng.normal(size=shape_q).astype(np.float32)
    kp = rng.normal(size=(n_blocks, bs, g, d)).astype(np.float32)
    vp = rng.normal(size=(n_blocks, bs, g, d)).astype(np.float32)
    tables, seq = _paged_state(rng, b, n_blocks, max_blocks, bs, t)
    want = jax_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(seq), window=window, interpret=True,
    )
    args = [torch.from_numpy(x) for x in (q, kp, vp, tables, seq)]
    got = cuda_paged.paged_decode_attention(*args, window=window)
    assert got.shape == shape_q
    assert _err(want, got) <= TOL


def test_paged_wrapper_validates_shapes():
    q = torch.zeros(2, 4, 16)
    kp = torch.zeros(8, 8, 3, 16)
    with pytest.raises(ValueError, match="divide"):
        cuda_paged.paged_decode_attention(q, kp, kp, torch.zeros(2, 2, dtype=torch.int32),
                                          torch.zeros(2, dtype=torch.int32))
    kp = torch.zeros(8, 8, 2, 16)
    with pytest.raises(ValueError, match="batch"):
        cuda_paged.paged_decode_attention(q, kp, kp, torch.zeros(3, 2, dtype=torch.int32),
                                          torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("window,with_mask", [(0, False), (5, False), (0, True)])
def test_naive_attention_matches_jax(window, with_mask):
    rng = np.random.default_rng(window + 7 * with_mask)
    b, tq, tk, h, g, d = 2, 6, 10, 4, 2, 8
    q = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tk, g, d)).astype(np.float32)
    v = rng.normal(size=(b, tk, g, d)).astype(np.float32)
    qpos = np.arange(tq) + 3
    kpos = np.arange(tk)
    mask = None
    if with_mask:
        mask = kpos[None, :] >= np.array([[0], [2]])  # row 1's first slots are dead
    want = jax_naive_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(qpos),
        kv_positions=jnp.asarray(kpos), kv_mask=None if mask is None else jnp.asarray(mask),
        window=window,
    )
    got = naive_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kpos),
        kv_mask=None if mask is None else torch.from_numpy(mask), window=window,
    )
    assert _err(want, got) <= TOL


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, size=(2, 5, 16)).astype(np.float32)
    p = {"scale": rng.normal(size=16).astype(np.float32), "bias": rng.normal(size=16).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    want = jlayers.apply_norm(kind, {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x), 1e-5)
    got = layers.apply_norm(kind, {k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x), 1e-5)
    assert _err(want, got) <= TOL
    # bf16 input: fp32 math, result cast back to bf16.
    got16 = layers.apply_norm(kind, {k: torch.from_numpy(a) for k, a in p.items()},
                              torch.from_numpy(x).bfloat16(), 1e-5)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["gelu", "relu"])
def test_activations_match_jax(kind):
    x = np.linspace(-6, 6, 101).astype(np.float32)
    want = jlayers.activation_fn(kind, jnp.asarray(x))
    got = layers.activation_fn(kind, torch.from_numpy(x))
    assert _err(want, got) <= TOL


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_jax(per_row):
    rng = np.random.default_rng(4)
    b, t, h, d, ctx = 2, 5, 3, 8, 32
    x = rng.normal(size=(b, t, h, d)).astype(np.float32)
    pos = rng.integers(0, ctx, size=(b, t) if per_row else (t,))
    jcos, jsin = jlayers.rope_table(ctx, d, 10000.0)
    cos, sin = layers.rope_table(ctx, d, 10000.0, torch.device("cpu"))
    assert _err(jcos, cos) <= TOL and _err(jsin, sin) <= TOL
    want = jlayers.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    got = layers.apply_rope(torch.from_numpy(x), cos, sin, torch.from_numpy(pos))
    assert _err(want, got) <= TOL
