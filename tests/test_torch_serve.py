"""Serving (prefill, the decode caches and decode) of the PyTorch port
against the reference on the CPU, for the decoder archs of
``ASSIGNED_ARCHS`` at ``reduce_for_smoke`` with the reference's weights.

Tolerance: rtol 1e-4 / atol 1e-4 for every logit and cache leaf
(measured: at most 1.0e-5 abs over every arch, prefill and four decode
steps; fp32 sums in another order), positions exact.  The port's own
properties mirror tests/test_arch_smoke.py at its tolerances (decode
against the forward 5e-3, decode against a longer prefill 2e-3).
The bf16 local path is held to the reference's bf16 logits within 0.06 abs
(measured 0.020-0.031 over four token draws: up to two bf16 ulps of
logits near 3, activations rounded to bf16 after ops in another order).

jamba is compared twice: against the reference's ``mamba_impl="pallas"``
route (the one the port's ``ssm_scan`` kernel replaces) at a 24-token
prompt, and against its default ``"chunked"`` XLA route at 32 tokens.  At
a prompt that is not a multiple of its 16-step chunk, the chunked route
pads the sequence with zeros and carries the final state through the pad
steps, whose dt is not zero, so its cached ``h`` decays (ROADMAP queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_for_smoke as jreduce
from repro.launch.serve import serve_demo as j_serve_demo
from repro.models import attention as jattn
from repro.models import decode_fn as jdecode
from repro.models import init_cache as j_init_cache
from repro.models import init_params as jinit
from repro.models import mamba as jmb
from repro.models import predict_fn as jpredict
from repro.models import prefill_fn as jprefill
from repro.models import rwkv6 as jrw
from repro.models import transformer as jtfm
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduce_for_smoke
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.launch.serve import serve_demo
from repro_torch.models import (decode_fn, from_numpy_params, init_cache,
                                init_params, predict_fn, prefill_fn)
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import rwkv6 as rw
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)
B, GEN, FRAMES = 2, 4, 20
TOL = dict(rtol=1e-4, atol=1e-4)
FRONTENDS = ("internvl2-2b", "whisper-tiny")

# id -> (arch, prompt, changes to both configs, changes to the reference's
# alone, cache headroom for the decode steps)
CASES = {a: (a, 24, {}, {}, True) for a in ASSIGNED_ARCHS
         if a not in FRONTENDS}
CASES["jamba-1.5-large-398b"] = ("jamba-1.5-large-398b", 24, {},
                                 {"mamba_impl": "pallas"}, True)
CASES["jamba-chunked-32"] = ("jamba-1.5-large-398b", 32, {}, {}, True)
# a ring that wraps in prefill (40 > 16) and again in decode
CASES["gemma3-window16"] = ("gemma3-27b", 40, {"sliding_window": 16}, {},
                            True)
# no headroom: decode past the last slot of a global cache overwrites it
CASES["olmo-no-headroom"] = ("olmo-1b", 24, {}, {}, False)


def configs(arch, changes=None, ref_changes=None):
    changes = changes or {}
    jcfg = dataclasses.replace(jreduce(jget(arch)), **changes,
                               **(ref_changes or {}))
    return jcfg, dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                     **changes)


def reference_weights(jcfg, seed=0):
    return jax.tree.map(np.asarray, jinit(jcfg, jax.random.key(seed)))


def serve_batch(cfg, prompt, seed=1):
    """(batch of numpy arrays, the GEN tokens decode feeds (B, GEN))."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, prompt + GEN)).astype(
        np.int32)
    batch = {"tokens": toks[:, :prompt]}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    return batch, toks[:, prompt:]


def _np(tree):
    return tree_map(lambda t: t.numpy().copy(), tree)


def cache_len(cfg, prompt, headroom=True):
    """The ``max_len`` a case serves with: room for the GEN steps (and a
    vlm's patch prefix), or None (the prompt's own length)."""
    if not headroom:
        return None
    return prompt + GEN + (cfg.vision_tokens if cfg.family == "vlm" else 0)


def reference_serve(jcfg, w, batch, nxt, max_len):
    """The reference's jitted prefill and its decode steps fed ``nxt``'s
    columns: a list of (logits, cache) in numpy, after prefill and after
    each step."""
    jp = jax.tree.map(jnp.asarray, w)
    ref = [jax.jit(jprefill(jcfg, max_len=max_len))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})]
    jd = jax.jit(jdecode(jcfg))
    for i in range(nxt.shape[1]):
        ref.append(jd(jp, jnp.asarray(nxt[:, i:i + 1]), ref[-1][1]))
    return [(np.asarray(lg), jax.tree.map(np.asarray, c)) for lg, c in ref]


def run_both(jcfg, tcfg, prompt, headroom=True):
    """The reference's and the port's prefill and GEN decode steps on the
    same weights and tokens: {"ref": [...], "port": [...]}, each a list of
    (logits, cache) in numpy, after prefill and after each step."""
    w = reference_weights(jcfg)
    batch, nxt = serve_batch(jcfg, prompt)
    max_len = cache_len(jcfg, prompt, headroom)
    ref = reference_serve(jcfg, w, batch, nxt, max_len)
    tp = from_numpy_params(w, device="cpu")
    logits, cache = prefill_fn(tcfg, max_len=max_len)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    port = [(logits.numpy(), _np(cache))]
    step = decode_fn(tcfg)
    for i in range(GEN):
        tok = nxt[:, i:i + 1]
        # the step writes the cache in place: keep a copy of each
        logits, cache = step(tp, torch.from_numpy(tok), cache)
        port.append((logits.numpy(), _np(cache)))
    return {"ref": ref, "port": port}


def assert_caches_match(port, ref, what):
    """Same keys and shapes leaf by leaf, ``pos`` equal, values within
    TOL."""
    jl = jax.tree_util.tree_leaves_with_path(ref)
    tl = list(leaves_with_paths(port))
    assert [tuple(k.key for k in p) for p, _ in jl] == [p for p, _ in tl]
    for (path, r), (_, t) in zip(jl, tl):
        name = f"{what}: " + "/".join(k.key for k in path)
        assert r.shape == t.shape and r.dtype == t.dtype, name
        np.testing.assert_allclose(t, r, err_msg=name, **TOL)


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request):
    arch, prompt, changes, ref_changes, headroom = CASES[request.param]
    jcfg, tcfg = configs(arch, changes, ref_changes)
    return run_both(jcfg, tcfg, prompt, headroom)


def test_prefill_logits_match_reference(served):
    (pl, _), (rl, _) = served["port"][0], served["ref"][0]
    assert pl.shape == rl.shape == (B, 1, pl.shape[-1])
    np.testing.assert_allclose(pl, rl, **TOL)


def test_prefill_cache_matches_reference(served):
    assert_caches_match(served["port"][0][1], served["ref"][0][1],
                        "prefill")


def test_decode_steps_match_reference(served):
    for i, ((pl, pc), (rl, rc)) in enumerate(zip(served["port"][1:],
                                                 served["ref"][1:])):
        np.testing.assert_allclose(pl, rl, err_msg=f"step {i}", **TOL)
        assert_caches_match(pc, rc, f"decode step {i}")


# ---------------------------------------------------------------------------
# Units against the reference's functions of the same name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ring", "empty_slots", "per_row"])
def test_decode_attention_matches_reference(case):
    rng = np.random.default_rng(3)
    b, s, h, kv, hd = 3, 12, 4, 2, 16
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    if case == "ring":          # slot order is not position order
        pos = np.array(jtfm._ring_positions(s, jnp.int32(29), 10))
    elif case == "empty_slots":
        pos = np.where(np.arange(s) < 5, np.arange(s), -1).astype(np.int32)
    else:                       # (B, S): each row its own filled slots
        pos = np.stack([np.where(np.arange(s) < n, np.arange(s), -1)
                        for n in (1, 7, 12)]).astype(np.int32)
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v, pos)))
    got = attn.decode_attention(*map(torch.from_numpy, (q, k, v, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("slots,pos,window", [(8, 0, 8), (8, 5, 8),
                                              (8, 21, 8), (16, 40, 16),
                                              (10, 29, 10)])
def test_cache_positions_match_reference(slots, pos, window):
    p = torch.tensor(pos, dtype=torch.int32)
    np.testing.assert_array_equal(
        tfm._ring_positions(slots, p, window).numpy(),
        np.asarray(jtfm._ring_positions(slots, jnp.int32(pos), window)))
    np.testing.assert_array_equal(
        tfm._full_positions(slots, p).numpy(),
        np.asarray(jtfm._full_positions(slots, jnp.int32(pos))))


def first_layer(w, pidx):
    """Pattern entry ``pidx``'s first stacked layer of a weight tree."""
    return tree_map(lambda a: a[0], w["stack"][pidx])


def _lift(tree):
    """One model's numpy tree as a torch stack of one."""
    return tree_map(lambda a: torch.from_numpy(np.array(a))[None], tree)


@pytest.mark.parametrize("kind,s,q_offset", [
    ("global", 20, 0), ("global", 20, 5), ("local", 24, 0),
    ("local", 24, 3), ("local", 6, 0)])
def test_attention_block_matches_reference(kind, s, q_offset):
    """The local layer longer than its window (8) runs the window kernel's
    plain version at q_offset 0, and the reference's shifted masks
    otherwise."""
    jcfg, tcfg = configs("gemma3-27b", {"sliding_window": 8})
    p = first_layer(reference_weights(jcfg, 2), "p0")["attn"]
    x = np.random.default_rng(4).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    want = jattn.attention_block(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), jcfg, kind=kind,
                                 q_offset=q_offset)
    got = attn.attention_block(_lift(p), torch.from_numpy(x)[None], tcfg,
                               kind=kind, q_offset=q_offset)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_mamba_decode_step_matches_reference():
    jcfg, tcfg = configs("jamba-1.5-large-398b")
    w = reference_weights(jcfg, 2)
    p = first_layer(w, "p1")["mamba"]      # ("global", "mamba")
    rng = np.random.default_rng(5)
    di, n, cw = mb.d_inner(tcfg), tcfg.ssm_state_dim, tcfg.ssm_conv_width
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, cw - 1, di)).astype(np.float32)
    h = rng.standard_normal((3, di, n)).astype(np.float32) * 0.1
    jy, (jconv, jh) = jmb.mamba_decode_step(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
        (jnp.asarray(conv), jnp.asarray(h)))
    ty, (tconv, th) = mb.mamba_decode_step(
        _lift(p), torch.from_numpy(x)[None], tcfg,
        (torch.from_numpy(conv)[None], torch.from_numpy(h)[None]))
    for got, want in ((ty, jy), (tconv, jconv), (th, jh)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_mamba_block_carries_state_as_reference():
    """``mamba_block(state=)``: the conv state and h0 continue a sequence;
    against the reference's kernel route (its chunked route decays a
    carried state through its zero padding)."""
    jcfg, tcfg = configs("jamba-1.5-large-398b", {},
                         {"mamba_impl": "pallas"})
    p = first_layer(reference_weights(jcfg, 2), "p1")["mamba"]
    rng = np.random.default_rng(6)
    di, n, cw = mb.d_inner(tcfg), tcfg.ssm_state_dim, tcfg.ssm_conv_width
    x = rng.standard_normal((2, 11, tcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, cw - 1, di)).astype(np.float32)
    h = rng.standard_normal((2, di, n)).astype(np.float32) * 0.1
    jy, (jconv, jh) = jmb.mamba_block(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
        (jnp.asarray(conv), jnp.asarray(h)))
    ty, (tconv, th) = mb.mamba_block(
        _lift(p), torch.from_numpy(x)[None], tcfg,
        (torch.from_numpy(conv)[None], torch.from_numpy(h)[None]))
    for got, want in ((ty, jy), (tconv, jconv), (th, jh)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fn", ["time_mix_step", "rwkv_block_one_token"])
def test_time_mix_step_matches_reference(fn):
    """The decode step alone, and ``rwkv_block``'s dispatch of a one-token
    sequence to it (both packages pick the step at S = 1)."""
    jcfg, tcfg = configs("rwkv6-3b")
    w = reference_weights(jcfg, 2)
    layer = first_layer(w, "p0")
    p = layer["rwkv"]
    rng = np.random.default_rng(7)
    hh, nn = rw.rwkv_heads(tcfg)
    d = tcfg.d_model
    x = rng.standard_normal((3, 1, d)).astype(np.float32)
    prev = rng.standard_normal((3, d)).astype(np.float32)
    hs = rng.standard_normal((3, hh, nn, nn)).astype(np.float32) * 0.1
    jx = jnp.asarray(x)
    if fn == "time_mix_step":
        want = jrw.time_mix_step(jax.tree.map(jnp.asarray, p), jx, jcfg,
                                 (jnp.asarray(prev), jnp.asarray(hs)))
        got = rw.time_mix_step(_lift(p), torch.from_numpy(x)[None], tcfg,
                               (torch.from_numpy(prev)[None],
                                torch.from_numpy(hs)[None]))
        pairs = [(got[0], want[0]), (got[1][0], want[1][0]),
                 (got[1][1], want[1][1])]
    else:
        from repro.models.layers import apply_norm as j_norm
        from repro_torch.models.layers import apply_norm as t_norm
        tl = _lift(layer)
        jl = jax.tree.map(jnp.asarray, layer)
        state = (prev, hs, prev)
        want = jrw.rwkv_block(
            jl["rwkv"], jx, jcfg, tuple(map(jnp.asarray, state)),
            lambda i, v: j_norm(jl[("ln1", "ln2")[i]], v, jcfg))
        got = rw.rwkv_block(
            tl["rwkv"], torch.from_numpy(x)[None], tcfg,
            tuple(torch.from_numpy(a)[None] for a in state),
            lambda i, v: t_norm(tl[("ln1", "ln2")[i]], v, tcfg))
        pairs = [(got[0], want[0])] + list(zip(got[1], want[1]))
    for g, w_ in pairs:
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# The port's own properties (tests/test_arch_smoke.py's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,changes", [
    ("olmo-1b", {}), ("gemma3-27b", {}),
    ("gemma3-27b", {"sliding_window": 16}), ("rwkv6-3b", {}),
    ("jamba-1.5-large-398b", {}), ("granite-moe-3b-a800m", {})],
    ids=["olmo", "gemma3", "gemma3-window16", "rwkv6", "jamba", "granite"])
def test_multi_token_decode_matches_forward(arch, changes):
    """Decode after prefill reproduces the forward's logits at each step
    (cache headroom, rings that wrap, mamba / rwkv state continuity).
    Capacity unbound, as the reference's test does: the MoE drop depends
    on the group size, which differs between prefill and decode."""
    n_gen, prompt = 4, 45
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              moe_capacity_factor=16.0, **changes)
    params = init_params(cfg, 5, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, prompt + n_gen)).astype(np.int32))
    full = predict_fn(cfg)(params, {"tokens": toks})
    _, cache = prefill_fn(cfg, max_len=prompt + n_gen)(
        params, {"tokens": toks[:, :prompt]})
    step = decode_fn(cfg)
    for i in range(n_gen):
        lg, cache = step(params, toks[:, prompt + i:prompt + i + 1], cache)
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   full[:, prompt + i].numpy(), rtol=5e-3,
                                   atol=5e-3, err_msg=f"{arch} step {i}")
    assert int(cache["pos"]) == prompt + n_gen


def test_decode_matches_prefill_continuation():
    """Decoding token t+1 after prefill(t) gives prefill(t+1)'s logits."""
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    params = init_params(cfg, 3, device="cpu")
    s = 32
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, s + 1)).astype(np.int32))
    lg_full, _ = prefill_fn(cfg)(params, {"tokens": toks})
    _, cache = prefill_fn(cfg, max_len=s + 1)(params, {"tokens": toks[:, :s]})
    lg_dec, _ = decode_fn(cfg)(params, toks[:, s:], cache)
    np.testing.assert_allclose(lg_full[:, -1].numpy(), lg_dec[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_init_cache_is_the_reference_tree():
    """Keys, shapes and dtypes of an empty cache, the audio ``xk`` / ``xv``
    included; all zeros."""
    for arch in ("gemma3-27b", "jamba-1.5-large-398b", "rwkv6-3b",
                 "whisper-tiny"):
        jcfg, tcfg = configs(arch)
        want = j_init_cache(jcfg, 3, 20, enc_len=7)
        got = init_cache(tcfg, 3, 20, enc_len=7, device="cpu")
        jl = jax.tree_util.tree_leaves_with_path(want)
        tl = list(leaves_with_paths(got))
        assert [tuple(k.key for k in p) for p, _ in jl] == \
            [p for p, _ in tl], arch
        for (_, r), (_, t) in zip(jl, tl):
            assert r.shape == tuple(t.shape) and not t.any()
            assert str(r.dtype) == str(t.dtype).replace("torch.", "")


def test_init_cache_without_device_raises_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)


def test_serve_demo_gives_the_reference_tokens(capsys):
    """``serve_demo`` on the reference's weights: the reference demo's
    greedy token ids."""
    jcfg = jreduce(jget("rwkv6-3b"))
    w = reference_weights(jcfg)
    want = j_serve_demo(["--arch", "rwkv6-3b"])
    got = serve_demo(["--arch", "rwkv6-3b", "--device", "cpu"],
                     init_fn=lambda cfg: from_numpy_params(w, device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert "generated token ids" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Repair: a bf16 local layer longer than its window
# ---------------------------------------------------------------------------

def test_bf16_local_layer_hands_float32_to_window_attention(monkeypatch):
    """gemma3 reduced, at bfloat16, window 8 < S 32: the window kernel's
    wrapper (which takes float32 only on the card) sees float32, as the
    reference's local path computes in fp32; the forward's and prefill's
    logits stay within 0.06 of the reference's at the same bf16 weights."""
    changes = dict(sliding_window=8, param_dtype="bfloat16",
                   compute_dtype="bfloat16")
    jcfg, tcfg = configs("gemma3-27b", changes)
    w32 = jax.tree.map(np.asarray, jinit(dataclasses.replace(
        jcfg, param_dtype="float32"), jax.random.key(0)))
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), w32)
    w = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    tp = tree_map(lambda t: t.to(torch.bfloat16),
                  from_numpy_params(w, device="cpu"))
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (B, 32))
    seen = []
    real = attn.window_attention

    def spy(q, k, v, window):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, window)
    monkeypatch.setattr(attn, "window_attention", spy)
    tb = {"tokens": torch.from_numpy(toks.astype(np.int32))}
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    got = predict_fn(tcfg)(tp, tb)
    got_pf, _ = prefill_fn(tcfg)(tp, tb)
    assert seen and all(d == (torch.float32,) * 3 for d in seen), seen
    assert got.dtype == got_pf.dtype == torch.bfloat16
    want = jax.jit(jpredict(jcfg))(jp, jb)
    want_pf, _ = jax.jit(jprefill(jcfg))(jp, jb)
    for g, r in ((got, want), (got_pf, want_pf)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   rtol=0, atol=0.06)
