"""The port's RoPE, attention functions and sliding-window attention against
the reference on the CPU (the kernel's plain version; the CUDA kernels are
held to the same plain version on the card by ``chip_smoke.py``).

Tolerances: RoPE at rtol 1e-6 / atol 1e-6 (the same fp32 rotation; cos and
sin of angles up to 1e3 may differ by an ulp between the libraries); the
three attention functions at rtol 1e-5 / atol 1e-6 against
``repro.models.attention`` (the same online softmax; fp32 sums in another
order); ``window_attention`` at rtol 1e-4 / atol 1e-5 against the
reference's interpret-mode Pallas kernel and its dense oracle (the
tolerance ``chip_smoke.py`` holds the CUDA forward to); its gradients at
rtol 1e-4 / atol 1e-5 against ``jax.grad`` of the reference's
``local_blockwise_attention``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.window_attn.ops import window_attention as j_window
from repro.kernels.window_attn.ref import window_attention_ref as j_window_ref
from repro.models import attention as jattn
from repro.models.layers import apply_rope as j_apply_rope
from repro.models.layers import rope_freqs as j_rope_freqs
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.window_attn import ops
from repro_torch.kernels.window_attn.ops import window_attention
from repro_torch.kernels.window_attn.ref import window_attention_ref
from repro_torch.models import attention as tattn
from repro_torch.models.layers import apply_rope, rope_freqs

torch.set_num_threads(1)
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
WIN_TOL = dict(rtol=1e-4, atol=1e-5)


def _qkv(b, s, h, kv, hd, seed, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


def _t(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ------------------------------------------------------------------ RoPE

@pytest.mark.parametrize("shape,theta", [((2, 12, 3, 8), 10_000.0),
                                         ((1, 2, 40, 2, 16), 1_000_000.0),
                                         ((3, 5, 1, 6), 10_000.0)])
def test_rope_matches_reference(shape, theta):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    seq = shape[-3]
    positions = np.arange(seq, dtype=np.int32)[None] * 25   # angles to 1e3
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(positions), theta)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(positions), theta)
    _close(got, want, rtol=1e-6, atol=1e-6)
    _close(rope_freqs(shape[-1], theta), j_rope_freqs(shape[-1], theta),
           rtol=1e-7, atol=0)


# ------------------------------------------------- the attention functions

@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,bq,bkv", [
    (2, 37, 4, 2, 8, True, 0, 16, 8),       # ragged blocks, GQA
    (1, 37, 4, 4, 8, True, 10, 512, 512),   # one block, window
    (2, 24, 6, 2, 4, True, 5, 8, 16),
    (1, 20, 2, 1, 8, False, 0, 8, 8),       # bidirectional
])
def test_blockwise_attention_matches_reference(b, s, h, kv, hd, causal,
                                               window, bq, bkv):
    q, k, v = _qkv(b, s, h, kv, hd, seed=s + window)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal, window=window,
                                     block_q=bq, block_kv=bkv)
    got = tattn.blockwise_attention(*_t((q, k, v)), causal=causal,
                                    window=window, block_q=bq, block_kv=bkv)
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    _close(got, want, **ATTN_TOL)


def test_blockwise_attention_with_offset_and_positions():
    """A query block at an offset against a longer kv with some slots
    marked unfilled (position -1)."""
    q, k, v = _qkv(2, 8, 4, 2, 8, seed=3, sk=24)
    pos = np.arange(24, dtype=np.int32)
    pos[[3, 17]] = -1
    kw = dict(causal=True, window=12, q_offset=16, block_q=4, block_kv=8)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                     kv_positions=jnp.asarray(pos), **kw)
    got = tattn.blockwise_attention(*_t((q, k, v)),
                                    kv_positions=torch.from_numpy(pos), **kw)
    _close(got, want, **ATTN_TOL)


@pytest.mark.parametrize("s,window,bq,bkv", [(64, 0, 16, 16),
                                             (64, 20, 32, 16),
                                             (37, 0, 0, 512)])  # ragged
def test_causal_skip_attention_matches_reference(s, window, bq, bkv):
    q, k, v = _qkv(2, s, 4, 2, 8, seed=s)
    kw = dict(window=window, block_q=bq, block_kv=bkv)
    want = jattn.causal_skip_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = tattn.causal_skip_attention(*_t((q, k, v)), **kw)
    _close(got, want, **ATTN_TOL)


@pytest.mark.parametrize("b,s,h,kv,hd,window,bq", [(2, 50, 4, 2, 8, 12, 16),
                                                   (1, 64, 4, 2, 16, 16, 512),
                                                   (1, 33, 2, 1, 5, 40, 8)])
def test_local_blockwise_attention_matches_reference(b, s, h, kv, hd, window,
                                                     bq):
    q, k, v = _qkv(b, s, h, kv, hd, seed=window)
    want = jattn.local_blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                           window=window, block_q=bq)
    got = tattn.local_blockwise_attention(*_t((q, k, v)), window=window,
                                          block_q=bq)
    _close(got, want, **ATTN_TOL)


# ----------------------------------------------- sliding-window attention

def _folded_ref(q, k, v, window):
    """The reference's (B*H, S, hd) oracle on GQA-expanded heads, back in
    (B, S, H, hd)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]

    def fold(x):
        return jnp.repeat(jnp.asarray(x), g, axis=2).transpose(
            0, 2, 1, 3).reshape(b * h, s, hd)
    out = j_window_ref(jnp.asarray(q).transpose(0, 2, 1, 3).reshape(
        b * h, s, hd), fold(k), fold(v), window)
    return out.reshape(b, h, s, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (1, 256, 2, 2, 64, 128),
    (2, 512, 4, 2, 64, 100),     # GQA + non-multiple window
    (1, 384, 2, 1, 128, 256),    # hd 128, one kv head
])
def test_window_attention_matches_reference_kernel(b, s, h, kv, hd, window):
    """tests/test_kernels.py's shapes, the reference's Pallas kernel in
    interpret mode."""
    q, k, v = _qkv(b, s, h, kv, hd, seed=s + window)
    want = j_window(*map(jnp.asarray, (q, k, v)), window, blk=128)
    got = window_attention(*_t((q, k, v)), window)
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    _close(got, want, **WIN_TOL)


@pytest.mark.parametrize("b,s,h,kv,hd,window", [(2, 70, 4, 2, 64, 50),
                                                (1, 33, 3, 3, 5, 7),
                                                (2, 20, 4, 1, 16, 64),
                                                (1, 1, 2, 2, 8, 1)])
def test_window_attention_matches_reference_oracle(b, s, h, kv, hd, window):
    q, k, v = _qkv(b, s, h, kv, hd, seed=hd)
    got = window_attention(*_t((q, k, v)), window)
    _close(got, _folded_ref(q, k, v, window), **WIN_TOL)
    _close(window_attention_ref(*_t((q, k, v)), window),
           _folded_ref(q, k, v, window), **WIN_TOL)


@pytest.mark.parametrize("b,s,h,kv,hd,window,bq", [(2, 40, 4, 2, 8, 12, 16),
                                                   (1, 70, 2, 1, 16, 50, 32)])
def test_window_attention_gradients_match_reference(b, s, h, kv, hd, window,
                                                    bq):
    q, k, v = _qkv(b, s, h, kv, hd, seed=window)
    gy = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jattn.local_blockwise_attention(q_, k_, v_, window=window,
                                              block_q=bq)
        return jnp.sum(out * jnp.asarray(gy))
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    t = _t((q, k, v), grad=True)
    out = window_attention(*t, window)
    got = torch.autograd.grad((out * torch.from_numpy(gy)).sum(), t)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")


def test_window_attention_on_cpu_launches_nothing():
    before = dict(LAUNCHES)
    q, k, v = _t(_qkv(1, 9, 2, 1, 4, seed=0))
    torch.testing.assert_close(window_attention(q, k, v, 3),
                               window_attention_ref(q, k, v, 3), rtol=0,
                               atol=0)
    assert LAUNCHES == before


def test_wrapper_checks_shapes_and_dtypes():
    q, k, v = _t(_qkv(2, 8, 4, 2, 16, seed=0))
    ops._check(q, k, v, 4)
    with pytest.raises(ValueError, match="hd=129"):
        w = torch.zeros(2, 8, 4, 129)
        ops._check(w, w[:, :, :2], w[:, :, :2], 4)
    with pytest.raises(ValueError, match="do not split"):
        ops._check(q, k[:, :, :1].expand(2, 8, 3, 16),
                   v[:, :, :1].expand(2, 8, 3, 16), 4)
    with pytest.raises(ValueError, match=r"\(B, S, KV, hd\)"):
        ops._check(q, k, v[:, :7], 4)
    with pytest.raises(ValueError, match="must be"):
        ops._check(q, k[:, :7], v[:, :7], 4)
    with pytest.raises(ValueError, match="window"):
        ops._check(q, k, v, 0)
    with pytest.raises(TypeError, match="float32"):
        ops._check(q.double(), k, v, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, 4)
