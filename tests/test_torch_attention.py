"""The port's RoPE, attention functions and sliding-window attention against
the reference on the CPU (the kernel's plain version; the CUDA kernels are
held to the same plain version on the card by ``chip_smoke.py``).

Tolerances: RoPE at rtol 1e-6 / atol 1e-6 (the same fp32 rotation; cos and
sin of angles up to 1e3 may differ by an ulp between the libraries); the
three attention functions at rtol 1e-5 / atol 1e-6 against
``repro.models.attention`` (the same online softmax; fp32 sums in another
order); ``window_attention`` at rtol 1e-4 / atol 1e-5 against the
reference's interpret-mode Pallas kernel and its dense oracle (the
tolerance ``chip_smoke.py`` holds the CUDA forward to), and so is the
CUDA forward's arithmetic emulated in torch; its gradients at
rtol 1e-4 / atol 1e-5 against ``jax.grad`` of the reference's
``local_blockwise_attention``.  The bf16 routes' arithmetic (the mma.sync
route's 64-key tiles and the wgmma / TMA route's 128-key tiles), emulated,
at 2e-2 of the reference's bf16 kernel and within 2^-8 (max|v| + |r|) of
the plain version; the route choice (head dim, alignment, strides of
fused QKV views) on CPU tensors.
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


def _tf32_parts(x):
    """x's 3xTF32 parts as ``split`` in csrc/window_attn.cu forms them on
    the int32 bit pattern: hi = (x + half a TF32 ulp) with the 13 low bits
    cleared, lo = x - hi the same way; the tensor core reads 19 bits of each."""
    mask = torch.tensor(-8192, dtype=torch.int32)          # 0xffffe000
    hi = ((x.view(torch.int32) + 0x1000) & mask).view(torch.float32)
    lo = (((x - hi).view(torch.int32) + 0x1000) & mask).view(torch.float32)
    return hi, lo


def _mm3(a, b):
    """a @ b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo dropped),
    fp32 sums."""
    (ah, al), (bh, bl) = _tf32_parts(a), _tf32_parts(b)
    return al @ bh + ah @ bl + ah @ bh


def _ex2(x):
    """ex2.approx.ftz's flush: results under 2^-126 are 0."""
    y = torch.exp2(x)
    return torch.where(y < 2.0 ** -126, 0.0, y)


def _kernel_arithmetic(q, k, v, window):
    """The forward kernel's arithmetic and walk on the CPU: S and P V in
    3xTF32, an online softmax in base 2 with the guard for rows that have
    seen no key yet, and the kernel's indexing: a query tile walks key
    tiles from k_lo, a 16-row warp skips a tile none of its rows sees,
    masks only where some pair of the query tile is out of the window, and
    on such a tile runs P V only over the 8-key steps its rows see.  Q, K and
    V are zero-filled past S, as staged.  Returns O (B, S, H, hd) and lse
    (B, H, S)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    sp = -(-s // 64) * 64
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, sp - s))
    qt = pad(q).transpose(1, 2)                             # (B, H, Sp, hd)
    kt, vt = (pad(x).repeat_interleave(g, 2).transpose(1, 2) for x in (k, v))
    c2 = hd ** -0.5 * 1.4426950408889634
    pos = torch.arange(sp)
    o = torch.zeros(b, h, sp, hd)
    lse = torch.zeros(b, h, sp)
    for q0 in range(0, sp, 64):
        k_lo = max(0, q0 - window + 1) // 64 * 64
        k_hi = min(s, q0 + 64)
        full = [k0 + 63 <= q0 and k0 + window > q0 + 63
                for k0 in range(k_lo, k_hi, 64)]
        for qw in range(q0, q0 + 64, 16):
            rows = slice(qw, qw + 16)
            kw_lo, kw_hi = qw - window + 1, min(qw + 15, s - 1)
            m = torch.full((b, h, 16, 1), -torch.inf)
            l = torch.zeros(b, h, 16, 1)
            acc = torch.zeros(b, h, 16, hd)
            for k0, fl in zip(range(k_lo, k_hi, 64), full):
                if not (qw < s and kw_lo <= k0 + 63 and kw_hi >= k0):
                    continue
                kj, qi = pos[k0:k0 + 64], pos[rows, None]
                sc = _mm3(qt[:, :, rows], kt[:, :, k0:k0 + 64].transpose(2, 3))
                if not fl:
                    ok = (qi < s) & (kj < s) & (kj <= qi) & (kj > qi - window)
                    sc = torch.where(ok, sc, -torch.inf)
                mn = torch.maximum(m, sc.amax(-1, keepdim=True) * c2)
                none = mn == -torch.inf
                corr = torch.where(none, 1.0, _ex2(m - mn))
                p = torch.where(none, 0.0, _ex2(sc * c2 - mn))
                l = l * corr + p.sum(-1, keepdim=True)
                j_lo, j_hi = ((0, 8) if fl else
                              (max(0, kw_lo - k0) // 8,
                               min(8, (kw_hi - k0) // 8 + 1)))
                steps = slice(8 * j_lo, 8 * j_hi)
                acc = acc * corr + _mm3(p[..., steps],
                                        vt[:, :, k0:k0 + 64][:, :, steps])
                m = mn
            o[:, :, rows] = acc / l
            lse[:, :, rows] = ((m + torch.log2(l)) * 0.6931471805599453)[..., 0]
    return o[:, :, :s].transpose(1, 2), lse[..., :s]


@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (1, 200, 2, 1, 32, 100),     # window not a multiple of 64
    (2, 300, 4, 2, 16, 70),      # rows past 133: their first tiles masked
    (2, 100, 4, 2, 64, 1),       # window 1: one key a row
    (1, 130, 6, 3, 27, 70),      # hd 27
    (1, 256, 2, 1, 64, 127),     # lower edge at a tile's first key + 1
])
def test_window_attention_kernel_arithmetic_matches_reference(b, s, h, kv,
                                                              hd, window):
    """The CUDA forward's arithmetic (csrc/window_attn.cu), emulated in
    torch, against the reference's dense oracle at the kernel's
    tolerance."""
    q, k, v = _qkv(b, s, h, kv, hd, seed=window)
    o, lse = _kernel_arithmetic(*_t((q, k, v)), window)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    _close(o, _folded_ref(q, k, v, window), **WIN_TOL)
    logits = torch.einsum("bqhd,bshd->bhqs", *_t((q, np.repeat(
        k, h // kv, axis=2)))) * hd ** -0.5
    pos = torch.arange(s)
    ok = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)
    _close(lse, torch.where(ok, logits, -torch.inf).logsumexp(-1), **WIN_TOL)


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


# ---------------------------------------------------------------- bf16 operands

def _kernel_arithmetic_bf16(q, k, v, window, qtile=64, ktile=64, rows=16):
    """A bf16 forward route's arithmetic on the CPU: S = Q K^T of the bf16
    operands with fp32 sums (each bf16 product exact in fp32), the base-2
    online softmax of ``_kernel_arithmetic`` over ``ktile``-key tiles, P
    rounded to bf16 at the running max before P V (over all keys of a tile:
    masked keys have P = 0), the sum over the unrounded P, O rounded to
    bf16.  A ``qtile``-query tile walks the key tiles from k_lo, and each
    group of ``rows`` query rows skips a tile none of its rows sees.  The
    defaults are ``wattn_fwd_bf16_kernel``'s (64-query tiles, 64-key tiles,
    16-row warps); ``wattn_fwd_bf16_tma_kernel`` has 128-query tiles,
    128-key tiles and 64-row consumer warpgroups."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    sp = -(-s // qtile) * qtile
    pad = lambda x: torch.nn.functional.pad(x.float(),
                                            (0, 0, 0, 0, 0, sp + ktile - s))
    qt = pad(q).transpose(1, 2)
    kt, vt = (pad(x).repeat_interleave(g, 2).transpose(1, 2) for x in (k, v))
    c2 = hd ** -0.5 * 1.4426950408889634
    pos = torch.arange(sp + ktile)
    o = torch.zeros(b, h, sp + ktile, hd)
    for q0 in range(0, sp, qtile):
        k_lo = max(0, q0 - window + 1) // ktile * ktile
        k_hi = min(s, q0 + qtile)
        for qw in range(q0, q0 + qtile, rows):
            rs = slice(qw, qw + rows)
            kw_lo, kw_hi = qw - window + 1, min(qw + rows - 1, s - 1)
            m = torch.full((b, h, rows, 1), -torch.inf)
            l = torch.zeros(b, h, rows, 1)
            acc = torch.zeros(b, h, rows, hd)
            for k0 in range(k_lo, k_hi, ktile):
                if not (qw < s and kw_lo <= k0 + ktile - 1 and kw_hi >= k0):
                    continue
                kj, qi = pos[k0:k0 + ktile], pos[rs, None]
                sc = qt[:, :, rs] @ kt[:, :, k0:k0 + ktile].transpose(2, 3)
                ok = (qi < s) & (kj < s) & (kj <= qi) & (kj > qi - window)
                sc = torch.where(ok, sc, -torch.inf)
                mn = torch.maximum(m, sc.amax(-1, keepdim=True) * c2)
                none = mn == -torch.inf
                corr = torch.where(none, 1.0, _ex2(m - mn))
                p = torch.where(none, 0.0, _ex2(sc * c2 - mn))
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + (p.bfloat16().float()
                                    @ vt[:, :, k0:k0 + ktile])
                m = mn
            o[:, :, rs] = acc / l
    return o[:, :, :s].transpose(1, 2).bfloat16()


def _bf16_qkv(b, s, h, kv, hd, seed):
    return [torch.from_numpy(a).bfloat16() for a in _qkv(b, s, h, kv, hd,
                                                         seed)]


@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (2, 70, 4, 2, 64, 50), (1, 130, 6, 3, 27, 70), (2, 100, 4, 2, 64, 1),
    (1, 200, 2, 1, 32, 100)])
def test_window_attention_bf16_matches_reference_kernel(b, s, h, kv, hd,
                                                        window):
    """bf16 q, k, v: the plain version follows the TPU kernel's bf16
    arithmetic and returns bf16, held to the reference's interpret-mode
    Pallas kernel on the same bf16 operands at tests/test_kernels.py's bf16
    tolerance, 2e-2 (P is rounded to bf16 at another running max: the
    reference's 128-key blocks against the row's max).  The CUDA bf16
    route's arithmetic, emulated, within ``chip_smoke.py``'s bound of the
    plain version, 2^-8 (max|v| + |r|), and at 2e-2 of the reference."""
    q, k, v = _bf16_qkv(b, s, h, kv, hd, seed=window)
    got = window_attention(q, k, v, window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = j_window(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      for t in (q, k, v)), window, blk=128)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    emu = _kernel_arithmetic_bf16(q, k, v, window).float()
    bound = 2.0 ** -8 * (v.float().abs().max() + got.float().abs())
    assert bool(((emu - got.float()).abs() <= bound).all())
    np.testing.assert_allclose(emu.numpy(), want, rtol=2e-2, atol=2e-2)


def test_window_attention_bf16_gradients_are_bf16():
    """Autograd through the bf16 plain version gives each gradient in its
    operand's dtype, within 2e-2 of the fp32 gradients of the widened
    operands (the CUDA route widens the saved tensors for its fp32
    backward kernels and casts, as ``chip_smoke.py`` checks)."""
    q, k, v = (t.requires_grad_(True) for t in _bf16_qkv(2, 40, 4, 2, 16,
                                                          seed=5))
    gy = torch.from_numpy(np.random.default_rng(2).standard_normal(
        q.shape).astype(np.float32))
    got = torch.autograd.grad((window_attention(q, k, v, 12).float()
                               * gy).sum(), (q, k, v))
    wide = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad((window_attention(*wide, 12) * gy).sum(),
                               wide)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=2e-2,
                                   atol=2e-2)


# the wgmma / TMA route's tiles (csrc/window_attn_tma.cu)
TMA_TILES = dict(qtile=128, ktile=128, rows=64)


@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (2, 70, 4, 2, 64, 50), (1, 130, 6, 3, 27, 70), (2, 100, 4, 2, 64, 1),
    (1, 200, 2, 1, 32, 100),
    (1, 300, 4, 2, 128, 200),    # hd 128, S not a multiple of 128
    (1, 130, 2, 2, 128, 1),      # hd 128, window 1
    (1, 260, 8, 2, 64, 300),     # H / KV 4, window >= S
    (2, 384, 2, 2, 64, 129)])    # lower edge one key past a 128-key tile
def test_window_attention_bf16_tma_route_arithmetic(b, s, h, kv, hd, window):
    """The wgmma / TMA route's walk and rounding emulated on the CPU:
    128-query tiles whose two 64-row halves walk 128-key tiles, P rounded
    to bf16 at the running max of each 128-key tile.  Held to the
    reference's interpret-mode Pallas kernel on the same bf16 operands at
    tests/test_kernels.py's bf16 tolerance, 2e-2, and to the plain version
    within ``chip_smoke.py``'s bound, 2^-8 (max|v| + |r|)."""
    q, k, v = _bf16_qkv(b, s, h, kv, hd, seed=window + hd)
    emu = _kernel_arithmetic_bf16(q, k, v, window, **TMA_TILES).float()
    assert emu.shape == q.shape and torch.isfinite(emu).all()
    want = j_window(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      for t in (q, k, v)), window, blk=128)
    np.testing.assert_allclose(emu.numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    plain = window_attention_ref(q, k, v, window).float()
    bound = 2.0 ** -8 * (v.float().abs().max() + plain.abs())
    assert bool(((emu - plain).abs() <= bound).all())


def test_window_attention_bf16_tma_route_rounds_at_its_own_tiles():
    """The two routes round P at the running max of their own key tiles
    (64 and 128 keys), so where a row's max grows inside a 128-key tile
    their results differ: the emulations are not the same bits, and each
    is within the plain version's bound."""
    q, k, v = _bf16_qkv(1, 256, 2, 1, 64, seed=3)
    old = _kernel_arithmetic_bf16(q, k, v, 256).float()
    new = _kernel_arithmetic_bf16(q, k, v, 256, **TMA_TILES).float()
    assert not torch.equal(old, new)
    plain = window_attention_ref(q, k, v, 256).float()
    bound = 2.0 ** -8 * (v.float().abs().max() + plain.abs())
    for emu in (old, new):
        assert bool(((emu - plain).abs() <= bound).all())


def _fused_qkv(b, s, h, kv, hd, extra=0, dtype=torch.bfloat16):
    """q, k, v as views of one (B, S, (H + 2 KV) hd + extra) projection, as
    a fused QKV linear layer returns them."""
    w = (h + 2 * kv) * hd + extra
    x = torch.randn(b, s, w, generator=torch.Generator().manual_seed(0)
                    ).to(dtype)
    q = x[..., :h * hd].unflatten(-1, (h, hd))
    k = x[..., h * hd:(h + kv) * hd].unflatten(-1, (kv, hd))
    v = x[..., (h + kv) * hd:(h + 2 * kv) * hd].unflatten(-1, (kv, hd))
    return q, k, v


@pytest.mark.parametrize("hd,h,kv,want", [
    (64, 4, 2, "tma"), (128, 32, 16, "tma"), (128, 4, 4, "tma"),
    (64, 8, 2, "tma"), (16, 4, 2, "mma_sync"), (27, 6, 3, "mma_sync"),
    (32, 2, 1, "mma_sync"), (96, 4, 2, "mma_sync")])
def test_window_attention_bf16_route_by_head_dim(hd, h, kv, want):
    """Contiguous operands: the wgmma / TMA route at hd 64 and 128 at any
    GQA ratio (1, 2, 4), mma.sync at every other head dim."""
    q, k, v = (torch.zeros(2, 40, n, hd, dtype=torch.bfloat16)
               for n in (h, kv, kv))
    assert ops.bf16_route(q, k, v) == want


def test_window_attention_bf16_route_by_alignment_and_strides():
    """TMA needs a 16-byte aligned base and strides of multiples of 16
    bytes: views of a fused QKV projection take it when the projection's
    row is a multiple of 8 elements, not when it is padded by 4 or when a
    view starts 2 bytes in; a dim of extent 1 does not count."""
    q, k, v = _fused_qkv(2, 40, 4, 2, 64)
    assert q.stride() == (40 * 512, 512, 64, 1)
    assert ops.bf16_route(q, k, v) == "tma"
    assert ops.bf16_route(*_fused_qkv(1, 40, 32, 16, 128)) == "tma"
    assert ops.bf16_route(*_fused_qkv(2, 40, 4, 2, 64, extra=4)) == \
        "mma_sync"
    buf = torch.zeros(2 * 40 * 4 * 64 + 1, dtype=torch.bfloat16)
    shifted = buf[1:].view(2, 40, 4, 64)
    assert ops.bf16_route(shifted, k, v) == "mma_sync"
    assert ops.bf16_route(q, k, shifted[:, :, :2]) == "mma_sync"
    one = torch.zeros(1, 40, 4, 64, dtype=torch.bfloat16).as_strided(
        (1, 40, 4, 64), (3, 256, 64, 1))
    assert ops.bf16_route(one, k[:1], v[:1]) == "tma"
    assert ops.bf16_route(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, v) == "tma"


@pytest.mark.parametrize("extra", [0, 4])
def test_window_attention_bf16_on_fused_qkv_views(extra):
    """Strided views of one fused projection on CPU tensors, which run the
    plain version: ``window_attention`` reads the views through their
    strides and gives the plain version's bits on contiguous copies.  On
    the card these views take the wgmma route unpadded and the mma.sync
    route padded by 4 (asserted here), each held to the plain version by
    ``chip_smoke.py``'s phase 3e; the wgmma route's walk and rounding are
    held by ``test_window_attention_bf16_tma_route_arithmetic``."""
    q, k, v = _fused_qkv(2, 70, 4, 2, 64, extra=extra)
    assert ops.bf16_route(q, k, v) == ("tma" if extra == 0 else "mma_sync")
    got = window_attention(q, k, v, 50)
    want = window_attention_ref(q.contiguous(), k.contiguous(),
                                v.contiguous(), 50)
    assert torch.equal(got, want)
