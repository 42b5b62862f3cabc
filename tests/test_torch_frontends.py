"""The audio (whisper-tiny) and vision-prefix (internvl2-2b) families of the
PyTorch port against the reference on the CPU: their configs in the
registry, parameter trees, the audio encoder and cross-attention, training
forwards and gradients with frames / patches, and serving (prefill, the
caches with the audio ``xk`` / ``xv``, decode), at ``reduce_for_smoke``
with the reference's weights.

Tolerances: serving as tests/test_torch_serve.py (rtol 1e-4 / atol 1e-4;
measured at most 7.4e-6 abs); ``encode_audio`` and the forward's logits
at rtol 1e-4 / atol 1e-5; the loss at rtol 1e-5 and each gradient leaf
within 1e-4 of the leaf's largest entry (fp32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import (B, FRONTENDS, GEN, TOL, assert_caches_match,
                              configs, reference_weights, run_both,
                              serve_batch)

from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import get_config as jget
from repro.models import loss_fn as jloss
from repro.models import transformer as jtfm
from repro.models.params import RealInit as JRealInit
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.models import (decode_fn, from_numpy_params, init_params,
                                loss_fn, num_params, predict_fn, prefill_fn)
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)


def test_registry_holds_the_frontend_configs():
    """Both configs load from the port's registry field for field as the
    reference's, and ``check_kinds`` refuses neither."""
    assert ASSIGNED_ARCHS == J_ASSIGNED
    for arch in FRONTENDS:
        tcfg, jcfg = get_config(arch), jget(arch)
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        tfm.check_kinds(tcfg)
        assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", FRONTENDS)
def test_init_tree_is_the_reference_s(arch):
    """Same paths and shapes as the reference's tree: ``frontend_proj``,
    the audio ``encoder`` / ``enc_ln`` and the decoder's ``lnx`` /
    ``xattn``."""
    jcfg, tcfg = configs(arch)
    want = jax.tree_util.tree_leaves_with_path(jax.eval_shape(
        lambda k: jtfm.init_lm(JRealInit(k, jnp.float32), jcfg),
        jax.random.key(0)))
    got = list(leaves_with_paths(init_params(tcfg, 0, device="cpu")))
    assert [tuple(k.key for k in p) for p, _ in want] == [p for p, _ in got]
    for (_, w), (_, g) in zip(want, got):
        assert tuple(w.shape) == tuple(g.shape)
    paths = {p for p, _ in got}
    assert ("frontend_proj",) in paths
    if arch == "whisper-tiny":
        assert ("enc_ln", "scale") in paths
        assert ("stack", "p0", "xattn", "wq") in paths
        assert len({p[1] for p in paths if p[0] == "encoder"}) == \
            tcfg.encoder_layers


def test_encode_audio_matches_reference():
    jcfg, tcfg = configs("whisper-tiny")
    w = reference_weights(jcfg, 3)
    frames = np.random.default_rng(2).standard_normal(
        (3, 37, jcfg.d_model)).astype(np.float32)
    want = jtfm.encode_audio(jax.tree.map(jnp.asarray, w), jcfg,
                             jnp.asarray(frames), jtfm.NULL_CTX)
    tp = tree_map(lambda t: t[None], from_numpy_params(w, device="cpu"))
    got = tfm.encode_audio(tp, tcfg, torch.from_numpy(frames)[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_forward_and_gradients_with_frontend_match_reference(arch):
    """Training on the two families: logits of ``forward_train`` with
    frames / patches, the loss and every gradient leaf."""
    jcfg, tcfg = configs(arch)
    w = reference_weights(jcfg, 4)
    batch, _ = serve_batch(jcfg, 16, seed=5)
    batch["labels"] = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, batch["tokens"].shape).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, w)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits, _ = jtfm.forward_train(jp, jcfg, jb)
    (jv, _), jg = jax.value_and_grad(jloss(jcfg), has_aux=True)(jp, jb)
    tp = tree_map(lambda t: t.requires_grad_(True),
                  from_numpy_params(w, device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got_logits = predict_fn(tcfg)(tp, tb)
    assert got_logits.shape == want_logits.shape
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-5)
    tv, _ = loss_fn(tcfg)(tp, tb)
    grads = torch.autograd.grad(tv, tree_leaves(tp))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for (path, _), g, r in zip(leaves_with_paths(tp), grads,
                               jax.tree.leaves(jg)):
        r = np.asarray(r)
        np.testing.assert_allclose(
            g.numpy(), r, rtol=0, atol=1e-4 * max(float(np.abs(r).max()),
                                                  1e-30),
            err_msg="/".join(path))


@pytest.fixture(scope="module", params=FRONTENDS)
def served(request):
    jcfg, tcfg = configs(request.param)
    return run_both(jcfg, tcfg, 24)


def test_prefill_logits_match_reference(served):
    (pl, _), (rl, _) = served["port"][0], served["ref"][0]
    assert pl.shape == rl.shape == (B, 1, pl.shape[-1])
    np.testing.assert_allclose(pl, rl, **TOL)


def test_prefill_cache_matches_reference(served):
    """The audio decoder's layers hold the memory's cross-attention keys
    and values (``xk`` / ``xv``); the vlm cache counts the patch prefix."""
    assert_caches_match(served["port"][0][1], served["ref"][0][1],
                        "prefill")


def test_decode_steps_match_reference(served):
    for i, ((pl, pc), (rl, rc)) in enumerate(zip(served["port"][1:],
                                                 served["ref"][1:])):
        np.testing.assert_allclose(pl, rl, err_msg=f"step {i}", **TOL)
        assert_caches_match(pc, rc, f"decode step {i}")


@pytest.mark.parametrize("arch", FRONTENDS)
def test_multi_token_decode_matches_forward(arch):
    """Decode after prefill reproduces the forward's logits at each step
    (tests/test_arch_smoke.py's property and tolerance): past the vlm's
    patch prefix, and against the audio memory's cached K/V."""
    cfg = configs(arch)[1]
    params = init_params(cfg, 5, device="cpu")
    prompt = 20
    batch, _ = serve_batch(cfg, prompt + GEN, seed=7)
    full_b = {k: torch.from_numpy(v) for k, v in batch.items()}
    full = predict_fn(cfg)(params, full_b)
    pre_b = dict(full_b, tokens=full_b["tokens"][:, :prompt])
    n_prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    _, cache = prefill_fn(cfg, max_len=n_prefix + prompt + GEN)(params,
                                                                pre_b)
    step = decode_fn(cfg)
    toks = full_b["tokens"]
    for i in range(GEN):
        lg, cache = step(params, toks[:, prompt + i:prompt + i + 1], cache)
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   full[:, prompt + i].numpy(), rtol=5e-3,
                                   atol=5e-3, err_msg=f"{arch} step {i}")
    assert int(cache["pos"]) == n_prefix + prompt + GEN
    assert num_params(params) == sum(v.numel() for v in tree_leaves(params))
