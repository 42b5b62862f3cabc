"""Coding parity of the PyTorch port against ``repro.core.coding`` and the
reference kernels' oracles, on the CPU: the port runs its kernels' plain
versions; the reference runs both its jnp path and its Pallas kernels in
interpret mode (``use_kernel=True``).  Tolerances are the ones
tests/test_kernels.py uses: 1e-5 for fp32, 2e-2 for bf16 slices, 1e-4 for
the calibrate accumulate; flatten helpers must match exactly.  The
encode-decode round trip returns w within tests/test_round_engine.py's
1e-3 (all clients) and 2e-3 (a subset of ids)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coding as jc
from repro.core import unlearning as ju
from repro.kernels.calibrate.ops import calibrate_update as j_cal_kernel
from repro.kernels.calibrate.ref import calibrate_update_ref as j_cal_ref
from repro.kernels.coded_matmul.ops import coded_encode_decode as j_ed_kernel
from repro.kernels.coded_matmul.ref import coded_matmul_ref as j_cm_ref
from repro_torch.core import coding as tc
from repro_torch.core import unlearning as tu
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.calibrate.ops import (calibrate_splits,
                                               calibrate_update)
from repro_torch.kernels.calibrate.ref import calibrate_update_ref
from repro_torch.kernels.coded_matmul.ops import (coded_encode_decode,
                                                  coded_matmul,
                                                  coded_matmul_rounds)
from repro_torch.kernels.coded_matmul.ref import (coded_encode_decode_ref,
                                                  coded_matmul_ref,
                                                  coded_matmul_rounds_ref)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _w(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("c,s,p", [(20, 4, 257), (8, 2, 130), (5, 1, 3)])
def test_encode_matches_reference(use_kernel, c, s, p):
    w = _w((s, p), c + p)
    ref = jc.encode(jc.CodingScheme(s, c), jnp.asarray(w),
                    use_kernel=use_kernel)
    got = tc.encode(tc.CodingScheme(s, c), torch.from_numpy(w))
    assert got.shape == (c, p) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_encode_batched_matches_reference(use_kernel):
    mats = [_w((4, 100 + 7 * g), g) for g in range(3)]
    ref = jc.encode_batched(jc.CodingScheme(4, 12),
                            [jnp.asarray(m) for m in mats],
                            use_kernel=use_kernel)
    got = tc.encode_batched(tc.CodingScheme(4, 12),
                            [torch.from_numpy(m) for m in mats])
    assert len(got) == len(ref) == 3
    for a, b in zip(ref, got):
        np.testing.assert_allclose(_np(b), _np(a), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_encode_rounds_matches_reference(use_kernel):
    sch = jc.CodingScheme(3, 10)
    hist = _w((4, 3, 150), 11)
    enc = np.asarray(sch.encode_matrix(), np.float32)
    ref = jc.encode_rounds(jnp.asarray(enc), jnp.asarray(hist),
                           use_kernel=use_kernel)
    got = tc.encode_rounds(torch.from_numpy(enc), torch.from_numpy(hist))
    assert got.shape == (4, 10, 150)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("ids", [list(range(20)), [0, 5, 10, 15],
                                 [1, 2, 3, 8, 13, 17, 19]])
def test_decode_erasure_matches_reference(use_kernel, ids):
    w = _w((4, 200), 3)
    slices = np.asarray(jc.encode(jc.CodingScheme(4, 20), jnp.asarray(w)))
    sub = slices[ids]
    ref = jc.decode_erasure(jc.CodingScheme(4, 20), jnp.asarray(sub), ids,
                            use_kernel=use_kernel)
    got = tc.decode_erasure(tc.CodingScheme(4, 20), torch.from_numpy(sub),
                            ids)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("available,bad", [
    (None, []), ([0, 1, 2, 3, 6, 9, 12, 15, 18, 19], []),
    (None, [2, 8, 12]), (list(range(1, 20)), [4, 11])])
def test_decode_robust_matches_reference(use_kernel, available, bad):
    w = _w((4, 64), 5)
    slices = np.array(jc.encode(jc.CodingScheme(4, 20), jnp.asarray(w)))
    rng = np.random.default_rng(9)
    slices[bad] += rng.standard_normal((len(bad), 64)).astype(np.float32) * 10
    rw, rlost, rbad = jc.decode_robust(jc.CodingScheme(4, 20),
                                       jnp.asarray(slices), available,
                                       use_kernel=use_kernel)
    tw, tlost, tbad = tc.decode_robust(tc.CodingScheme(4, 20),
                                       torch.from_numpy(slices), available)
    assert (rlost, rbad) == (tlost, tbad)
    np.testing.assert_allclose(_np(tw), _np(rw), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("s,c,p,ids", [(4, 20, 321, None),
                                       (4, 20, 1000, [1, 4, 9, 17]),
                                       (3, 15, 64, [2, 6, 9, 14]),
                                       (2, 8, 5, None)])
def test_encode_decode_matches_reference(use_kernel, s, c, p, ids):
    """Both of the reference's forms: the precomposed (S, S) operator and
    its fused Pallas kernel."""
    w = _w((s, p), p)
    ref = jc.encode_decode(jc.CodingScheme(s, c), jnp.asarray(w), ids,
                           use_kernel=use_kernel)
    got = tc.encode_decode(tc.CodingScheme(s, c), torch.from_numpy(w), ids)
    assert got.shape == (s, p) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    tol = 1e-3 if ids is None else 2e-3
    np.testing.assert_allclose(_np(got), w, rtol=tol, atol=tol)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("s,c,p", [(20, 40, 257), (8, 520, 64)])
def test_coding_matches_reference_past_the_register_tile(use_kernel, s, c, p):
    """S = 20 > 16 and C*S = 4160 > 4096: the shapes the CUDA coding
    kernels once refused.  At S = 20 the all-clients round-trip operator
    has entries near 7e4, and the reference's two forms (precomposed
    (S, S) operator, fused kernel) differ by 0.06 there; the port computes
    the kernel's dec @ (enc @ w), so that case is held to the kernel form."""
    sch_j, sch_t = jc.CodingScheme(s, c), tc.CodingScheme(s, c)
    w = _w((s, p), s + c)
    ref = jc.encode(sch_j, jnp.asarray(w), use_kernel=use_kernel)
    got = tc.encode(sch_t, torch.from_numpy(w))
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    slices = np.asarray(ref)
    subset = list(range(0, c, c // s))[:s]
    for ids in (list(range(c)), subset):
        ref = jc.decode_erasure(sch_j, jnp.asarray(slices[ids]), ids,
                                use_kernel=use_kernel)
        got = tc.decode_erasure(sch_t, torch.from_numpy(slices[ids]), ids)
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    for ids, form in ((subset, use_kernel), (None, True)):
        ref = jc.encode_decode(sch_j, jnp.asarray(w), ids, use_kernel=form)
        got = tc.encode_decode(sch_t, torch.from_numpy(w), ids)
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    np.testing.assert_allclose(_np(tc.encode_decode(sch_t, torch.from_numpy(w),
                                                    subset)), w,
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_calibrate_stacked_matches_reference_past_1024_clients(use_kernel):
    """M = 2048 retained clients: past the CUDA kernel's old M <= 1024."""
    m = 2048
    w = jax.tree.map(lambda a: a[0], _stacked_tree(1, 1))
    deltas = _stacked_tree(m, 2)
    norms = np.random.default_rng(3).uniform(0.5, 2.0, m).astype(np.float32)
    ref = ju.calibrate_stacked(jax.tree.map(jnp.asarray, w),
                               jax.tree.map(jnp.asarray, deltas),
                               jnp.asarray(norms), use_kernel=use_kernel)
    got = tu.calibrate_stacked(_to_torch(w), _to_torch(deltas),
                               torch.from_numpy(norms))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), got))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,p", [(4, 1001), (4, 1002), (4, 1003),
                                 (63, 1025), (64, 1026), (65, 2051)])
def test_calibrate_routes_match_reference(m, p):
    """The shapes that pick each route of the CUDA kernel: ragged P % 4 of
    1, 2 and 3 (row tiles staged from unaligned rows) and M on both sides
    of the split threshold (63 unsplit; 64 and 65 summed in two ranges of a
    cluster).  The port's plain version against the reference's Pallas
    kernel (interpret mode) and its oracle."""
    w, d, cf = _w((p,), m), _w((m, p), m + 1), _w((m,), m + 2)
    assert calibrate_splits(m, p, 132) == (1 if m < 64 else 2)
    got = calibrate_update(*map(torch.from_numpy, (w, d, cf)))
    for ref in (j_cal_kernel(*map(jnp.asarray, (w, d, cf))),
                j_cal_ref(*map(jnp.asarray, (w, d, cf)))):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sms,m,p,want", [
    (132, 4, 206_922, 1),          # the main path's M' = 4: never split
    (132, 63, 206_922, 1),         # the threshold: ranges of >= 32 rows
    (132, 64, 206_922, 2),
    (132, 2048, 206_922, 8),       # 102 tiles: the cluster's limit
    (132, 100, 1000, 3),           # M // 32
    (132, 2048, 1_079_296, 8),     # 527 tiles of 2048 columns
    (132, 2048, 1_079_297, 1),     # 528 tiles = 4 x 132: no split
    (114, 2048, 1_079_296, 1)])
def test_calibrate_split_choice(sms, m, p, want):
    assert calibrate_splits(m, p, sms) == want


@pytest.mark.parametrize("s,c,p", [(4, 20, 130), (20, 40, 257),
                                   (65, 33, 131), (130, 140, 67)])
def test_encode_decode_routes_match_reference(s, c, p):
    """The CUDA kernels' routes: the register tile (S 4, C 20); the tiled
    kernel with one pass of output rows and one chunk of clients (S 20,
    C 40), two passes (S 65), and w staged in chunks of 128 rows with three
    chunks of 64 clients (S 130, C 140).  Random operators scaled as an
    encode/decode pair; the port's plain dec @ (enc @ w) against the
    reference's fused Pallas kernel (interpret mode)."""
    enc = _w((c, s), 1) * s ** -0.5
    dec = _w((s, c), 2) * c ** -0.5
    w = _w((s, p), 3)
    got = coded_encode_decode(*map(torch.from_numpy, (enc, dec, w)))
    ref = j_ed_kernel(*map(jnp.asarray, (enc, dec, w)))
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_encode_decode_plain_version():
    """On CPU tensors the wrapper is the plain ``dec @ (enc @ w)`` and
    launches nothing; it agrees with the product in float64."""
    enc, dec, w = _w((20, 4), 1), _w((4, 20), 2), _w((4, 77), 3)
    before = dict(LAUNCHES)
    args = [torch.from_numpy(a) for a in (enc, dec, w)]
    got = coded_encode_decode(*args)
    assert LAUNCHES == before
    torch.testing.assert_close(got, coded_encode_decode_ref(*args), rtol=0,
                               atol=0)
    want = dec.astype(np.float64) @ (enc.astype(np.float64) @ w)
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("c,s,p", [(20, 4, 333), (1, 1, 5), (16, 3, 128)])
def test_plain_kernels_match_reference_oracles(c, s, p):
    coeff, w = _w((c, s), 1), _w((s, p), 2)
    ref = j_cm_ref(jnp.asarray(coeff), jnp.asarray(w))
    got = coded_matmul_ref(torch.from_numpy(coeff), torch.from_numpy(w))
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    hist = _w((3, s, p), 4)
    ref_r = jnp.stack([j_cm_ref(jnp.asarray(coeff), jnp.asarray(h))
                       for h in hist])
    got_r = coded_matmul_rounds_ref(torch.from_numpy(coeff),
                                    torch.from_numpy(hist))
    np.testing.assert_allclose(_np(got_r), _np(ref_r), **TOL)


@pytest.mark.parametrize("m,p", [(4, 1000), (1, 7), (9, 4096)])
def test_calibrate_plain_matches_reference(m, p):
    w, d, cf = _w((p,), 1), _w((m, p), 2), _w((m,), 3)
    ref = j_cal_ref(jnp.asarray(w), jnp.asarray(d), jnp.asarray(cf))
    got = calibrate_update_ref(*map(torch.from_numpy, (w, d, cf)))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4, atol=1e-4)


def test_wrappers_use_plain_versions_on_cpu():
    """CPU tensors take the plain versions and count no kernel launch."""
    before = dict(LAUNCHES)
    coeff, w = torch.from_numpy(_w((6, 2), 1)), torch.from_numpy(_w((2, 9), 2))
    torch.testing.assert_close(coded_matmul(coeff, w),
                               coded_matmul_ref(coeff, w), rtol=0, atol=0)
    h = torch.from_numpy(_w((2, 2, 9), 3))
    torch.testing.assert_close(coded_matmul_rounds(coeff, h),
                               coded_matmul_rounds_ref(coeff, h),
                               rtol=0, atol=0)
    v, d, cf = (torch.from_numpy(_w(s, i)) for i, s in
                enumerate([(9,), (2, 9), (2,)]))
    torch.testing.assert_close(calibrate_update(v, d, cf),
                               calibrate_update_ref(v, d, cf), rtol=0, atol=0)
    assert LAUNCHES == before


@pytest.mark.parametrize("use_kernel", [False, True])
def test_bf16_slices_match_reference(use_kernel):
    w = _w((4, 512), 2)
    ref = jc.encode(jc.CodingScheme(4, 16), jnp.asarray(w),
                    use_kernel=use_kernel, out_dtype=jnp.bfloat16)
    got = tc.encode(tc.CodingScheme(4, 16), torch.from_numpy(w),
                    out_dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)
    ids = [0, 5, 10, 15]
    rdec = jc.decode_erasure(jc.CodingScheme(4, 16), ref[jnp.asarray(ids)],
                             ids)
    tdec = tc.decode_erasure(tc.CodingScheme(4, 16), got[ids], ids)
    assert tdec.dtype == torch.float32
    np.testing.assert_allclose(_np(tdec), _np(rdec), rtol=2e-2, atol=2e-2)


def _stacked_tree(m, seed):
    rng = np.random.default_rng(seed)
    return {"conv": {"w": rng.standard_normal((m, 3, 3, 4)).astype(np.float32)},
            "dense": {"w": rng.standard_normal((m, 7, 5)).astype(np.float32),
                      "b": rng.standard_normal((m, 5)).astype(np.float32)},
            "a": rng.standard_normal((m, 2)).astype(np.float32)}


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def test_flatten_helpers_match_exactly():
    tree = _stacked_tree(3, 0)
    jf, jspec = jc.tree_to_flat_stacked(jax.tree.map(jnp.asarray, tree))
    tf, tspec = tc.tree_to_flat_stacked(_to_torch(tree))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    one = jax.tree.map(lambda a: a[1], tree)
    j1, _ = jc.tree_to_flat(jax.tree.map(jnp.asarray, one))
    t1, t1spec = tc.tree_to_flat(_to_torch(one))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(tf[1].numpy(), t1.numpy())
    back = tc.flat_to_tree(t1, t1spec)
    for a, b in zip(jax.tree.leaves(one), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), back))):
        np.testing.assert_array_equal(a, b)
    sback = tc.flat_to_stacked_tree(tf, tspec)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), sback))):
        np.testing.assert_array_equal(a, b)
    spec = tc.StackedRowSpec((4, 9, 2), int(tf.shape[1]), tspec)
    trees = tc.flat_to_client_trees(tf.reshape(-1), spec)
    assert list(trees) == [4, 9, 2]
    np.testing.assert_array_equal(trees[9]["dense"]["b"].numpy(),
                                  tree["dense"]["b"][1])


# ---------------------------------------------------------------- bf16 operands

def _bf16(a):
    """A numpy array rounded to bf16: (the torch tensor, the jax array)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("kernel", ["coded_matmul", "coded_matmul_rounds",
                                    "encode_decode", "calibrate"])
@pytest.mark.parametrize("mixed", [False, True])
def test_bf16_operands_match_reference_kernels(kernel, mixed):
    """Each coding kernel's plain version takes bf16 operands as the TPU
    kernel does (``mixed``: fp32 coefficients, bf16 w), against the
    reference's interpret-mode Pallas kernel on the same bf16 operands.
    Both widen bf16 exactly before fp32 products, so 1e-5 (the fp32
    tolerance) holds; the route gives the bits of its fp32 call on the
    widened operands, and the output is fp32 (or ``out_dtype``)."""
    from repro.kernels.coded_matmul.ops import coded_matmul as j_cm
    from repro.kernels.coded_matmul.ops import \
        coded_matmul_rounds as j_cm_rounds
    c, s, p = 20, 4, 1003
    coeff, w = _w((c, s), 1), _w((s, p), 2)
    if kernel == "coded_matmul_rounds":
        w = _w((3, s, p), 2)
    if kernel == "encode_decode":
        coeff = (_w((c, s), 1) * s ** -0.5, _w((s, c), 3) * c ** -0.5)
    if kernel == "calibrate":
        coeff, w = _w((4,), 1), (_w((p,), 4), _w((4, p), 2))
    if isinstance(coeff, tuple):
        tc_, jc_ = zip(*(_bf16(a) for a in coeff))
    elif mixed:
        tc_, jc_ = (torch.from_numpy(coeff),), (jnp.asarray(coeff),)
    else:
        tc_, jc_ = zip(_bf16(coeff))
    tw, jw = zip(*(_bf16(a) for a in (w if isinstance(w, tuple) else (w,))))
    port = {"coded_matmul": lambda: coded_matmul(*tc_, *tw),
            "coded_matmul_rounds": lambda: coded_matmul_rounds(*tc_, *tw),
            "encode_decode": lambda: coded_encode_decode(*tc_, *tw),
            "calibrate": lambda: calibrate_update(tw[0], tw[1], tc_[0])}
    ref = {"coded_matmul": lambda: j_cm(*jc_, *jw),
           "coded_matmul_rounds": lambda: j_cm_rounds(*jc_, *jw),
           "encode_decode": lambda: j_ed_kernel(*jc_, *jw),
           "calibrate": lambda: j_cal_kernel(jw[0], jw[1], jc_[0])}
    got = port[kernel]()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref[kernel]()), **TOL)
    tc_ = tuple(t.float() for t in tc_)
    tw = tuple(t.float() for t in tw)
    assert torch.equal(got, port[kernel]())
    if kernel == "coded_matmul":
        out16 = coded_matmul(tc_[0].bfloat16(), tw[0].bfloat16(),
                             out_dtype=torch.bfloat16)
        want = j_cm(jc_[0], jw[0], out_dtype=jnp.bfloat16)
        assert out16.dtype == torch.bfloat16
        np.testing.assert_allclose(out16.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2e-2, atol=2e-2)


def test_coding_wrappers_reject_other_dtypes():
    """float16 is neither of the kernels' operand types: the wrapper's own
    check raises before a launch (on the CPU the check is reached through
    the C-interface flags)."""
    from repro_torch import kernels as K
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.is_bf16(torch.zeros(2, dtype=torch.float16))
    assert K.is_bf16(torch.zeros(2, dtype=torch.bfloat16)) == 1
    with pytest.raises(TypeError, match="share one dtype"):
        K.operand_dtype(a=torch.zeros(2), b=torch.zeros(2).bfloat16())


# --------------------------------------- encode_decode's CUDA arithmetic, emulated

def _fma32(a, b, c):
    """fp32 fused multiply-add on float32 tensors: the product is exact in
    float64 and the sum rounds once to float32 (a second rounding of the
    float64 sum can differ from the card's single one only on a float64
    tie, which these inputs do not meet)."""
    return (a.double() * b.double() + c.double()).float()


def _ffma_arithmetic(enc, dec, w):
    """``encode_decode_kernel``'s arithmetic (csrc/coded_matmul.cu): S
    padded to SMAX (4, 8 or 16) with zero rows, and for every client in
    ascending order coded = fma over s ascending from 0, then out[s] =
    fma(dec[s, c], coded, out[s]).  float32 tensors in, (S, P) out."""
    c, s = enc.shape
    smax = 4 if s <= 4 else (8 if s <= 8 else 16)
    x = torch.zeros(smax, w.shape[1])
    x[:s] = w
    e = torch.zeros(c, smax)
    e[:, :s] = enc
    d = torch.zeros(smax, c)
    d[:s] = dec
    acc = torch.zeros(smax, w.shape[1])
    for ci in range(c):
        coded = torch.zeros(w.shape[1])
        for si in range(smax):
            coded = _fma32(e[ci, si].expand_as(coded), x[si], coded)
        acc = _fma32(d[:, ci:ci + 1].expand_as(acc), coded.expand_as(acc), acc)
    return acc[:s]


def _operators(s, c, ids):
    enc, dec = tc.encode_decode_operators(tc.CodingScheme(s, c), ids)
    return (torch.from_numpy(enc.astype(np.float32)),
            torch.from_numpy(dec.astype(np.float32)))


@pytest.mark.parametrize("s,c,p,ids", [(4, 20, 1027, None),
                                       (4, 20, 1027, [1, 6, 12, 19]),
                                       (4, 100, 3000, None),
                                       (4, 100, 3000, [0, 17, 42, 99]),
                                       (2, 20, 1027, None),
                                       (3, 20, 1026, [2, 5, 11])])
def test_encode_decode_kernel_arithmetic_matches_reference(s, c, p, ids):
    """The CUDA register-tile route's arithmetic, emulated on the CPU,
    against the reference's fused Pallas kernel (interpret mode) and the
    plain version, 1e-5 + 1e-5|r|: the CNN's operators (S 4, C 20, all
    clients and ids [1, 6, 12, 19]), the reference benchmark's (C 100, S 4,
    P cut to 3,000, all clients and four ids), and S 2 and 3, which the
    kernel pads to 4 with zero rows (P 1026: not a multiple of 4)."""
    enc, dec = _operators(s, c, ids)
    w = torch.from_numpy(_w((s, p), s + c + p))
    got = _ffma_arithmetic(enc, dec, w)
    ref = j_ed_kernel(*(jnp.asarray(t.numpy()) for t in (enc, dec, w)))
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               coded_encode_decode(enc, dec, w).numpy(), **TOL)


@pytest.mark.parametrize("c,ids", [(20, None), (100, [3, 31, 64, 97])])
def test_encode_decode_kernel_arithmetic_bf16_tables(c, ids):
    """bf16 tables and w, which the kernel widens exactly: the emulation on
    the widened operands against the reference's kernel on the same bf16
    operands, 1e-5 + 1e-5|r|."""
    enc, dec = (t.bfloat16().float() for t in _operators(4, c, ids))
    w = torch.from_numpy(_w((4, 1027), 5)).bfloat16().float()
    got = _ffma_arithmetic(enc, dec, w)
    ref = j_ed_kernel(*(jnp.asarray(t.numpy()).astype(jnp.bfloat16)
                        for t in (enc, dec, w)))
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("s,c", [(8, 20), (16, 40), (12, 30), (8, 64)])
def test_encode_decode_kernel_arithmetic_deeper_codes(s, c):
    """At S 8 and 16 the all-clients operators can be ill-conditioned
    (their round trip amplifies rounding), so a fixed tolerance would say
    little: the built route's arithmetic is held within twice the plain
    fp32 version's own distance to a float64 evaluation of dec @ (enc @
    w), max over the output."""
    enc, dec = _operators(s, c, None)
    w = torch.from_numpy(_w((s, 777), s + c))
    exact = dec.double() @ (enc.double() @ w.double())
    plain = float((coded_encode_decode(enc, dec, w).double() - exact)
                  .abs().max())
    got = _ffma_arithmetic(enc, dec, w)
    assert float((got.double() - exact).abs().max()) <= 2 * plain


# ----------------------------------- coded_matmul's routes by row alignment

@pytest.mark.parametrize("p", [1001, 1002, 1003, 1004])
@pytest.mark.parametrize("bf16", [False, True])
def test_coded_matmul_rounds_at_every_p_mod_4(p, bf16):
    """``coded_matmul_rounds`` on CPU tensors, which run the plain version
    (``ref.py``), at P = 1, 2, 3 and 0 mod 4, fp32 and bf16 operands,
    against the reference's interpret-mode Pallas kernel on the same
    operands (fp32 sums of exact products: 1e-5).  The CUDA kernel's
    routes at these P are held on the card (``chip_smoke.py``, phase 3e);
    which columns each of its threads reads and writes is held here by
    ``test_coded_matmul_column_walk``."""
    from repro.kernels.coded_matmul.ops import \
        coded_matmul_rounds as j_cm_rounds
    coeff, w = _w((20, 4), p), _w((3, 4, p), p + 1)
    if bf16:
        (tc_, jc_), (tw, jw) = _bf16(coeff), _bf16(w)
    else:
        tc_, tw = torch.from_numpy(coeff), torch.from_numpy(w)
        jc_, jw = jnp.asarray(coeff), jnp.asarray(w)
    got = coded_matmul_rounds(tc_, tw)
    assert got.shape == (3, 20, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j_cm_rounds(jc_, jw)),
                               **TOL)


def _at(n, offset, dtype):
    """A contiguous (n,) tensor that starts ``offset`` elements into a
    16-byte aligned buffer."""
    buf = torch.zeros(n + 8, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    return buf[offset:offset + n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coded_matmul_load_width(dtype):
    """The route choice: 4 columns a load when P % 4 == 0 and w and out
    start on 16 bytes; 2 when P is even and both start on two elements
    (the CNN stage's rounds: P = 5 x 206,922 = 2 mod 4); else 1."""
    from repro_torch.kernels.coded_matmul.ops import load_width
    out = torch.zeros(8, dtype=torch.float32)
    assert load_width(5 * 206_922, _at(8, 0, dtype), out) == 2
    assert load_width(1_034_612, _at(8, 0, dtype), out) == 4
    for p, want in ((1004, 4), (1002, 2), (1001, 1), (1003, 1)):
        assert load_width(p, _at(8, 0, dtype), out) == want
    assert load_width(1004, _at(8, 2, dtype), out) == 2
    assert load_width(1004, _at(8, 1, dtype), out) == 1
    assert load_width(1002, _at(8, 1, dtype), out) == 1
    assert load_width(1004, _at(8, 0, dtype), _at(8, 2, torch.float32)) == 2
    assert load_width(1004, _at(8, 0, dtype),
                      _at(8, 2, torch.bfloat16)) == 2
    assert load_width(1002, _at(8, 0, dtype), _at(8, 1, torch.float32)) == 1


# coded_matmul_kernel's walk over P (csrc/coded_matmul.cu): 256 threads a
# block, 1,024 columns a block; kW columns a load
_THREADS, _TILE_P = 256, 1024


def _walk(p, width):
    """(columns, in range) of every (block, thread, load) of
    ``coded_matmul_kernel`` at load width ``width``, as the kernel indexes
    them: 4 -> one 4-column load at tile + 4 t (a thread past P returns);
    2 -> pairs at tile + 2 t + 512 j, j = 0, 1, each masked as a whole;
    1 -> single columns at tile + t + 256 j, j = 0 .. 3, each masked."""
    tile = np.arange(-(-p // _TILE_P))[:, None, None] * _TILE_P
    t = np.arange(_THREADS)[None, :, None]
    if width == 4:
        first = tile + 4 * t
    elif width == 2:
        first = tile + 2 * t + np.arange(2)[None, None, :] * 2 * _THREADS
    else:
        first = tile + t + np.arange(4)[None, None, :] * _THREADS
    first = np.broadcast_to(first, (tile.shape[0], _THREADS, first.shape[2]))
    cols = first[..., None] + np.arange(width)
    return cols, first < p


@pytest.mark.parametrize("p,width", [
    (1004, 4), (1004, 2), (1004, 1), (1002, 2), (1002, 1), (1001, 1),
    (1003, 1), (1800, 2), (2050, 2)])
def test_coded_matmul_column_walk(p, width):
    """Each load width's walk (the pair route's at the CNN stage's P = 2
    mod 4 included, with tails that mask a thread's second pair or both)
    reads and writes every column of P once and none past it, each load
    on its width's alignment in every row ((g S + s) P + column a multiple
    of the width), a warp's loads contiguous; the output assembled from
    the walk's loads, fp32 sums over s in ascending order, is the plain
    version's."""
    g, c, s = 3, 20, 4
    cols, live = _walk(p, width)
    used = cols[live]                                 # (loads, width)
    assert used.max() < p
    assert np.array_equal(np.sort(used.ravel()), np.arange(p))
    for row in range(g * s):                          # every row of w
        assert ((row * p + used[:, 0]) % width == 0).all()
    warp0 = cols[0, :32, 0].ravel()                   # a warp's first loads
    assert np.array_equal(warp0, warp0[0] + np.arange(32 * width))
    coeff, w = _w((c, s), p), _w((g, s, p), p + 1)
    out = np.full((g, c, p), np.nan, dtype=np.float32)
    for load in used:
        acc = np.zeros((g, c, width), dtype=np.float32)
        for k in range(s):
            acc += coeff[None, :, k, None] * w[:, None, k, load]
        out[:, :, load] = acc
    want = coded_matmul_rounds_ref(torch.from_numpy(coeff),
                                   torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, want, **TOL)
