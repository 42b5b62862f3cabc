"""The published configs at their own numerics (bf16 params and bf16
compute) in the PyTorch port, against the reference on the CPU, at
``reduce_for_smoke`` widths with ``param_dtype`` and ``compute_dtype`` put
back to "bfloat16" and the reference's bf16 weights (``init_params`` at the
bf16 config, every leaf bf16):

- the production training steps (``launch.train``): ``make_fedavg_step``
  (adamw server), ``make_central_step`` (sgdm) and
  ``make_calibration_step``, on each arch ``tests/test_torch_train.py``
  covers, against the reference's jitted steps (its batch and options);
- serving (``launch.serve``'s prefill and four teacher-forced decode
  steps) on each decoder arch ``tests/test_torch_serve.py`` covers (jamba
  against the reference's ``mamba_impl="pallas"`` route, as there): its
  helpers here, its tests in ``tests/test_torch_bf16_serve.py`` with
  ``ssm_chunk_dtype="bfloat16"`` and the dry run's ``--profile``.

Tolerances.  bf16 rounding makes these steps sensitive: a one-ulp change
of the bf16 weights moves the reference's own outputs far more than fp32
rounding does.  So each output is held to twice the reference's one-ulp
spread, measured here at run time: over three draws (seeds 9, 10, 11) of
every nonzero bf16 weight moved one bf16 ulp up or down, the largest
distance of the reference's output at the moved weights from its output
at the weights.  The distances are taken piece by piece, so that no large
piece sets the bound of a small one:

- a scalar (``loss``, ``delta_norm``): its absolute difference;
- a step's new weights: the update (new - weights, in float32) of each
  leaf, each leaf's L2 distance against that leaf's own spread, so that
  the update is held and not the weights it is added to;
- the optimizer's ``mu``: each leaf's L2 distance likewise;
- serving's logits: each token's row (prefill's last token and each
  decode step's, per sequence), its L2 distance against that row's own
  spread: a token whose routing flips under the draws (granite-moe's)
  carries the flip in its own row's spread and in no other row's;
- serving's cache: each leaf's L2 distance.

Each step case also plants two faults in the port's update, a skipped one
(zero) and a sign-flipped one, and checks that the held distances refuse
both; ``test_bf16_planted_update_faults_fail`` plants them in the port's
server optimizer itself.  One case cannot refuse the skipped update
(``SKIP_UNSEEN``): granite-moe's central step, whose reference update
moves by more than half of itself in every leaf under the draws (routing
flips); its sign flip is refused.  A fault that rounds at another point
than the reference (a one-ulp change at some entries) moves these steps
less than the summation order of XLA against PyTorch does, and no step
tolerance can see it: the optimizers' bf16 arithmetic is held bit for bit
instead (``test_bf16_optimizer_updates_match_bit_for_bit``).  Running this
file as a script (``PYTHONPATH=src python tests/test_torch_bf16.py``)
prints, per case, the spreads' range and the port's largest distance in
spreads.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.launch.train as port_train
from repro.configs import FLConfig as JFL
from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget
from repro.configs import reduce_for_smoke as jreduce
from repro.launch.train import make_calibration_step as jcal
from repro.launch.train import make_central_step as jcentral
from repro.launch.train import make_fedavg_step as jfedavg
from repro.models import decode_fn as jdecode
from repro.models import init_params as jinit
from repro.models import prefill_fn as jprefill
from repro.optim import init_optimizer as j_init_opt
from repro.optim import make_optimizer as j_make_optimizer
from repro_torch.configs import (ASSIGNED_ARCHS, FLConfig, OptimizerConfig,
                                 get_config, reduce_for_smoke)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.train import (make_calibration_step,
                                      make_central_step, make_fedavg_step)
from repro_torch.models import (decode_fn, from_numpy_params, prefill_fn,
                                to_numpy_params)
from repro_torch.optim import init_optimizer, make_optimizer

torch.set_num_threads(1)
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
TRAIN_ARCHS = ("olmo-1b", "rwkv6-3b", "jamba-1.5-large-398b", "gemma3-27b",
               "granite-moe-1b-a400m", "whisper-tiny", "internvl2-2b")
SERVE_ARCHS = tuple(a for a in ASSIGNED_ARCHS
                    if a not in ("internvl2-2b", "whisper-tiny"))
STEPS = ("fedavg", "central", "calibration")
NC, BPC, FRAMES, GEN = 2, 2, 20, 4
SEQ = {"gemma3-27b": 80}          # past the reduced window (64)
FL = dict(fl_clients_per_step=NC, fl_local_steps=2)
HIST = np.asarray([0.5, 0.3], np.float32)
DRAWS = (9, 10, 11)
OPTS = {"fedavg": dict(name="adamw", lr=1e-3),
        "central": dict(name="sgdm", lr=1e-2)}
# the case whose skipped update no step tolerance sees (module docstring)
SKIP_UNSEEN = {("granite-moe-1b-a400m", "central")}


def configs(arch, ref_changes=None):
    jcfg = dataclasses.replace(jreduce(jget(arch)), **BF16,
                               **(ref_changes or {}))
    return jcfg, dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                     **BF16)


@functools.lru_cache(maxsize=None)
def reference_weights(jcfg, draw=None):
    """The reference's bf16 weights as numpy bf16 arrays; ``draw``: every
    nonzero entry moved one bf16 ulp, up or down by a fixed generator."""
    w = jax.tree.map(np.asarray, jinit(jcfg, jax.random.key(0)))
    if draw is None:
        return w
    rng = np.random.default_rng(draw)

    def moved(a):
        bits = a.view(np.uint16).astype(np.int32)
        step = np.where(rng.random(a.shape) < 0.5, -1, 1)
        bits = np.where((bits & 0x7fff) != 0, bits + step, bits)
        return bits.astype(np.uint16).view(a.dtype)
    return jax.tree.map(moved, w)


def client_batch(cfg, seed=1, lead=(NC, BPC)):
    rng = np.random.default_rng(seed)
    s = SEQ.get(cfg.name, 32)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, lead + (s,)),
             "labels": rng.integers(0, cfg.vocab_size, lead + (s,))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            lead + (cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            lead + (FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def leaves(tree):
    """A tree's leaves, widened to float32."""
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def update(new, weights):
    """Each leaf's new - old, in float32."""
    return [a - b for a, b in zip(leaves(new), leaves(weights))]


def _step_inputs(step, batch):
    if step == "central":
        return {k: v[0] for k, v in batch.items()}
    return batch


@functools.lru_cache(maxsize=None)
def _jitted(jcfg, step):
    if step == "fedavg":
        jo = JOpt(**OPTS[step])
        return jo, jax.jit(jfedavg(jcfg, JFL(**FL), jo))
    if step == "central":
        jo = JOpt(**OPTS[step])
        return jo, jax.jit(jcentral(jcfg, jo))
    return None, jax.jit(jcal(jcfg, JFL(**FL)))


@functools.lru_cache(maxsize=None)
def reference_step(jcfg, step, draw=None):
    """{output: float or list of per-leaf arrays} of the reference's jitted
    step on ``client_batch(jcfg)``, at ``reference_weights(jcfg, draw)``."""
    w = reference_weights(jcfg, draw)
    jp = jax.tree.map(jnp.asarray, w)
    jb = {k: jnp.asarray(v)
          for k, v in _step_inputs(step, client_batch(jcfg)).items()}
    jo, fn = _jitted(jcfg, step)
    if step == "calibration":
        new, m = fn(jp, jb, jnp.asarray(HIST))
        return {"loss": float(m["loss"]), "update": update(new, w)}
    (new, st), m = fn((jp, j_init_opt(jo, jp)), jb)
    out = {k: float(m[k]) for k in ("loss", "delta_norm") if k in m}
    return {**out, "update": update(new, w), "mu": leaves(st.mu)}


def port_outputs(weights, new, mu, m):
    """The same outputs of the port's step (numpy trees; ``mu`` None for
    the calibration step)."""
    out = {k: float(m[k]) for k in ("loss", "delta_norm") if k in m}
    out["update"] = update(new, weights)
    if mu is not None:
        out["mu"] = leaves(mu)
    return out


def port_step(tcfg, step, weights, batch):
    tp = from_numpy_params(weights, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _step_inputs(step,
                                                          batch).items()}
    if step == "fedavg":
        to = OptimizerConfig(**OPTS[step])
        (new, st), m = make_fedavg_step(tcfg, FLConfig(**FL), to)(
            (tp, init_optimizer(to, tp)), tb)
    elif step == "central":
        to = OptimizerConfig(**OPTS[step])
        (new, st), m = make_central_step(tcfg, to)(
            (tp, init_optimizer(to, tp)), tb)
    else:
        (new, m), st = make_calibration_step(tcfg, FLConfig(**FL))(
            tp, tb, torch.from_numpy(HIST)), None
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(new))
    return port_outputs(weights, to_numpy_params(new),
                        None if st is None else to_numpy_params(st.mu), m)


def distances(got, want) -> dict:
    """{output: distance}: a scalar's absolute difference, or an array of
    each piece's L2 distance (a tree's leaves, logits' rows)."""
    def one(a, b):
        if isinstance(b, float):
            return abs(a - b)
        assert len(a) == len(b)
        return np.asarray([np.sqrt(np.sum(np.square(
            x.astype(np.float64) - y))) for x, y in zip(a, b)])
    assert sorted(got) == sorted(want)
    return {k: one(got[k], want[k]) for k in want}


def spread_of(want, moved) -> dict:
    """The one-ulp spread: each output's (each piece's) largest distance
    over the draws' outputs ``moved`` from ``want``."""
    ds = [distances(m, want) for m in moved]
    return {k: np.max([d[k] for d in ds], axis=0) for k in want}


@functools.lru_cache(maxsize=None)
def step_spread(jcfg, step):
    return spread_of(reference_step(jcfg, step),
                     [reference_step(jcfg, step, d) for d in DRAWS])


def outside_spread(got, want, spread) -> list:
    """[(output, piece, distance, bound)] for every piece farther from the
    reference than twice its spread."""
    bad = []
    for k, d in distances(got, want).items():
        for i in np.flatnonzero(np.atleast_1d(d > 2 * spread[k])):
            bad.append((k, int(i), float(np.atleast_1d(d)[i]),
                        float(2 * np.atleast_1d(spread[k])[i])))
    return bad


def assert_within_spread(got, want, spread, what):
    bad = outside_spread(got, want, spread)
    assert not bad, (what, bad[:8])


def assert_refuses_faults(got, want, spread, what, skip=True):
    """The held distances refuse the port's update zeroed (skipped) and
    sign-flipped."""
    faults = {"sign-flipped": [-u for u in got["update"]]}
    if skip:
        faults["skipped"] = [np.zeros_like(u) for u in got["update"]]
    for fault, upd in faults.items():
        assert outside_spread({**got, "update": upd}, want, spread), (
            what, fault)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_bf16_step_matches_reference(arch, step):
    jcfg, tcfg = configs(arch)
    want, spread = reference_step(jcfg, step), step_spread(jcfg, step)
    got = port_step(tcfg, step, reference_weights(jcfg), client_batch(jcfg))
    assert_within_spread(got, want, spread, (arch, step))
    assert_refuses_faults(got, want, spread, (arch, step),
                          skip=(arch, step) not in SKIP_UNSEEN)


def _faulty_optimizer(fault):
    """``make_optimizer`` whose update is skipped (the weights returned as
    they came) or sign-flipped (w - (new - w), in fp32, cast back)."""
    def make(opt, stacked=True):
        init, upd = make_optimizer(opt, stacked)

        def faulty(params, grads, state):
            new, state = upd(params, grads, state)
            if fault == "skipped":
                return params, state
            return tree_map(lambda n, p: (2 * p.float() - n.float()).to(
                p.dtype), new, params), state
        return init, faulty
    return make


@pytest.mark.parametrize("fault", ["skipped", "sign-flipped"])
@pytest.mark.parametrize("step", ["fedavg", "central"])
def test_bf16_planted_update_faults_fail(step, fault, monkeypatch):
    """A fault planted in the port's optimizer (fedavg's server update,
    the central step's sgdm) is refused, on rwkv6-3b, the arch whose
    skipped server update the fewest leaves refuse."""
    jcfg, tcfg = configs("rwkv6-3b")
    monkeypatch.setattr(port_train, "make_optimizer",
                        _faulty_optimizer(fault))
    got = port_step(tcfg, step, reference_weights(jcfg), client_batch(jcfg))
    bad = outside_spread(got, reference_step(jcfg, step),
                         step_spread(jcfg, step))
    assert {k for k, *_ in bad} == {"update"}, bad


def _bf16_tree(rng, scale):
    """Leaves at magnitudes over many binades, bf16."""
    return {"a": (rng.standard_normal((64, 33)) * scale).astype(np.float32),
            "b": (rng.standard_normal((257,)) * scale * 40).astype(
                np.float32),
            "c": np.exp(rng.uniform(-12, 2, (128,))).astype(np.float32)}


@pytest.mark.parametrize("kw", [dict(name="sgd", lr=1e-2),
                                dict(name="sgdm", lr=1e-2),
                                dict(name="adamw", lr=1e-3),
                                dict(name="adamw", lr=1e-3,
                                     weight_decay=0.1)],
                         ids=["sgd", "sgdm", "adamw", "adamw_wd"])
def test_bf16_optimizer_updates_match_bit_for_bit(kw):
    """The port's optimizers on bf16 weights and gradients against the
    reference's, three steps, bit for bit: the update's rounding points
    (the learning rate rounded to bf16 as JAX's weak-typed constant is,
    fp32 moments, each product and difference cast back) are where a step
    tolerance cannot see them.  The clip is off (its norm's summation
    order differs)."""
    rng = np.random.default_rng(3)
    kw = dict(kw, grad_clip=0.0)
    jinit_fn, jupd = j_make_optimizer(JOpt(**kw))
    _, tupd = make_optimizer(OptimizerConfig(**kw), stacked=False)
    to_bf16 = functools.partial(jax.tree.map,
                                lambda a: jnp.asarray(a, jnp.bfloat16))
    jp = to_bf16(_bf16_tree(rng, 0.05))
    tp = from_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")
    jst, tst = jinit_fn(jp), init_optimizer(OptimizerConfig(**kw), tp)
    jupd = jax.jit(jupd)
    for _ in range(3):
        jg = to_bf16(_bf16_tree(rng, 0.01))
        tg = from_numpy_params(jax.tree.map(np.asarray, jg), device="cpu")
        jp, jst = jupd(jp, jg, jst)
        tp, tst = tupd(tp, tg, tst)
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                np.asarray(a, np.float32), b.float().numpy())


# ---------------------------------------------------------------- serving

SERVE_REF = {"jamba-1.5-large-398b": {"mamba_impl": "pallas"}}


def serve_batch(cfg, prompt=24, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, prompt + GEN)).astype(
        np.int32)
    return {"tokens": toks[:, :prompt]}, toks[:, prompt:]


def rows(steps_logits):
    """Each token's logits row, widened to float32: per step (prefill's
    last token, then each decode step), per sequence."""
    return [r for lg in steps_logits
            for r in np.asarray(lg, np.float32).reshape(
                np.shape(lg)[0], -1)]


@functools.lru_cache(maxsize=None)
def _serve_fns(jcfg, max_len):
    return (jax.jit(jprefill(jcfg, max_len=max_len)),
            jax.jit(jdecode(jcfg)))


@functools.lru_cache(maxsize=None)
def reference_serve(jcfg, draw=None):
    """Prefill's logits and each teacher-forced step's (``rows``), and the
    last cache's leaves, of the reference on ``serve_batch(jcfg)`` at
    ``reference_weights(jcfg, draw)``."""
    jp = jax.tree.map(jnp.asarray, reference_weights(jcfg, draw))
    batch, nxt = serve_batch(jcfg)
    prefill, decode = _serve_fns(jcfg, batch["tokens"].shape[1] + GEN)
    logits, cache = prefill(jp, {k: jnp.asarray(v)
                                 for k, v in batch.items()})
    out = [logits]
    for i in range(GEN):
        logits, cache = decode(jp, jnp.asarray(nxt[:, i:i + 1]), cache)
        out.append(logits)
    return {"logits": rows(out), "cache": leaves(cache)}


@functools.lru_cache(maxsize=None)
def serve_spread(jcfg):
    return spread_of(reference_serve(jcfg),
                     [reference_serve(jcfg, d) for d in DRAWS])


def port_serve(tcfg, weights, batch, nxt):
    tp = from_numpy_params(weights, device="cpu")
    max_len = batch["tokens"].shape[1] + GEN
    logits, cache = prefill_fn(tcfg, max_len=max_len)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    out = [logits]
    step = decode_fn(tcfg)
    for i in range(GEN):
        logits, cache = step(tp, torch.from_numpy(nxt[:, i:i + 1]), cache)
        out.append(logits)
    assert all(lg.dtype == torch.bfloat16 for lg in out)
    return {"logits": rows([lg.float().numpy() for lg in out]),
            "cache": leaves(to_numpy_params(cache))}


# ------------------------------------------------------ measuring spreads

def _report(what, got, want, spread):
    """One line: each output's spread range and the port's largest
    distance in spreads."""
    parts = []
    for k, d in distances(got, want).items():
        s = np.atleast_1d(spread[k])
        ratio = np.atleast_1d(d) / np.where(s > 0, s, np.inf)
        parts.append(f"{k}: spread {s.min():.4g}..{s.max():.4g}, port "
                     f"<= {ratio.max():.3g} spreads")
    print(what, "; ".join(parts), flush=True)


def measure(archs=TRAIN_ARCHS, serve_archs=SERVE_ARCHS):
    for arch in archs:
        jcfg, tcfg = configs(arch)
        for step in STEPS:
            got = port_step(tcfg, step, reference_weights(jcfg),
                            client_batch(jcfg))
            _report((arch, step), got, reference_step(jcfg, step),
                    step_spread(jcfg, step))
    for arch in serve_archs:
        jcfg, tcfg = configs(arch, SERVE_REF.get(arch))
        got = port_serve(tcfg, reference_weights(jcfg), *serve_batch(jcfg))
        _report((arch, "serve"), got, reference_serve(jcfg),
                serve_spread(jcfg))


if __name__ == "__main__":
    measure()
