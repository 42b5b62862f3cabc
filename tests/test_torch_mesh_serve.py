"""Serving of the PyTorch port sharded over a (data=2, model=2)
``DeviceMesh`` of 4 gloo ranks, against the reference's unsharded jitted
``prefill_fn`` / ``decode_fn`` on the CPU.

One world (``launch.mesh.spawn``; each rank runs ``serve_on_mesh``) serves
every case of ``CASES`` at ``reduce_for_smoke`` with the reference's
weights, under the rules of the published config: prefill under the
strategy ``resolve_strategy`` picks ("auto": sequence-parallel for
granite-moe-1b/3b, internvl2-2b, whisper-tiny, yi-6b and llama3.2-3b,
tensor-parallel for the rest), its cache laid out again by decode's
``cache_shardings``, then GEN teacher-forced decode steps.  Each case's
inputs are ``tests/test_torch_serve.py``'s (``serve_batch``, the decode
tokens it draws), cut to the case's batch rows; its reference side is that
file's ``reference_serve``, run in this process after the world.

Tolerance: ``tests/test_torch_serve.py``'s ``TOL`` (rtol 1e-4 / atol 1e-4,
positions exact) for prefill's logits and cache and every decode step's.
Every attention case's decode cache must have a leaf split along its slot
axis, every case leaves over ``data`` and over ``model``, each leaf laid
out as the policy says and kept so by every step: the checks cannot pass
on a replicated cache.

Also here, on the same world after the cases: the slot-sharded
``cached_attention`` against the reference's ``decode_attention`` (a ring,
empty slots, ranks whose slots are all empty, per-row positions), the slot
write that changes exactly one rank's shard, and sequence-parallel
attention that runs each rank's own query rows.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import CASES as SERVE_CASES
from test_torch_serve import (B, FRONTENDS, GEN, TOL, assert_caches_match,
                              cache_len, configs, first_layer,
                              reference_serve, reference_weights,
                              serve_batch)

from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import spawn
from repro_torch.launch.serve import serve_on_mesh
from repro_torch.launch.shardings import MeshShape

torch.set_num_threads(1)
MESH = "2x2"
MESH_SHAPE = MeshShape(("data", "model"), (2, 2))
SEQ_PARALLEL = {"granite-moe-1b-a400m", "granite-moe-3b-a800m",
                "internvl2-2b", "whisper-tiny", "yi-6b", "llama3.2-3b"}
KV_LEAVES = ("k", "v", "xk", "xv")

# id -> (arch, prompt, changes to both configs, changes to the reference's
# alone, cache headroom, strategy, batch rows)
CASES = {cid: (*c, "auto", B) for cid, c in SERVE_CASES.items()
         if cid != "jamba-chunked-32"}
CASES.update({a: (a, 24, {}, {}, True, "auto", B) for a in FRONTENDS})
CASES["llama3.2-3b-tp"] = ("llama3.2-3b", 24, {}, {}, True, "tp", B)
# batch 1, long_500k's layout: the slots over data x model
CASES["gemma3-batch1"] = ("gemma3-27b", 24, {}, {}, True, "auto", 1)
CASES["jamba-batch1"] = ("jamba-1.5-large-398b", 24, {},
                         {"mamba_impl": "pallas"}, True, "auto", 1)
assert set(ASSIGNED_ARCHS) <= set(CASES)


def _world_rank(rank, world_size, port_cases):
    """One rank of the test's world: ``serve_on_mesh`` of the cases, then
    the units (``_units_rank``)."""
    return (serve_on_mesh(rank, world_size, port_cases, MESH, "cpu"),
            _units_rank(rank, world_size))


@functools.lru_cache(maxsize=None)
def worlds():
    """(served, units): the serving cases, each (the world's result, the
    reference's [(logits, cache)]), and the units' results: the 4-rank
    world runs, then the reference.  A
    failure is kept and raised by every test that reads it, so that a
    failed world runs once, not once a test."""
    try:
        return _run_worlds(), None
    except Exception as e:  # noqa: BLE001 — raised again by each reader
        return None, e


def _run_worlds():
    inputs, port_cases = {}, []
    for cid, (arch, prompt, changes, ref_changes, headroom, strategy,
              rows) in CASES.items():
        jcfg, _ = configs(arch, changes, ref_changes)
        w = reference_weights(jcfg)
        batch, nxt = serve_batch(jcfg, prompt)
        batch = {k: v[:rows] for k, v in batch.items()}
        nxt = nxt[:rows]
        max_len = cache_len(jcfg, prompt, headroom)
        inputs[cid] = (jcfg, w, batch, nxt, max_len)
        port_cases.append(dict(arch=arch, changes=changes,
                               strategy=strategy, weights=w, batch=batch,
                               feed=nxt, max_len=max_len))
    # one after the other: a spawn beside a thread running the reference
    # has failed now and then with multiprocessing's "bootstrapping phase"
    port, unit_out = spawn(_world_rank, 4, "gloo", port_cases, timeout=600)
    ref = {cid: reference_serve(*inp) for cid, inp in inputs.items()}
    return {cid: (p, ref[cid]) for cid, p in zip(CASES, port)}, unit_out


def _worlds():
    out, err = worlds()
    if err is not None:
        raise err
    return out


def served():
    return _worlds()[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_prefill_matches_reference(case):
    port, ref = served()[case]
    rows = CASES[case][-1]
    assert port["logits"][0].shape == ref[0][0].shape == (
        rows, 1, ref[0][0].shape[-1])
    np.testing.assert_allclose(port["logits"][0], ref[0][0], **TOL)
    assert_caches_match(port["caches"][0], ref[0][1], "prefill")


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_decode_steps_match_reference(case):
    port, ref = served()[case]
    assert len(port["logits"]) == len(ref) == GEN + 1
    for i in range(1, GEN + 1):
        np.testing.assert_allclose(port["logits"][i], ref[i][0],
                                   err_msg=f"step {i}", **TOL)
        assert_caches_match(port["caches"][i], ref[i][1],
                            f"decode step {i}")


def _policy(case, cache, kind, strategy):
    """Each leaf's placements under the published config's rules for
    ``kind``, as ``serve_on_mesh`` reports them."""
    from repro_torch.core.tree import leaves_with_paths
    arch, changes = CASES[case][0], CASES[case][2]
    published = dataclasses.replace(get_config(arch), **changes)
    rules = sh.act_rules(published, kind, False, strategy)
    return {"/".join(p): [str(x) for x in pl] for p, pl in leaves_with_paths(
        sh.cache_shardings(cache, MESH_SHAPE, rules))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_caches_are_sharded_by_the_policy(case):
    """Prefill leaves its cache in its own rules' layout (kvseq over
    ``model`` under seq_parallel), decode's is ``cache_shardings``'; the
    attention leaves' slots are split, and some leaves lie over ``data``
    and some over ``model``."""
    port, _ = served()[case]
    arch, strategy = CASES[case][0], CASES[case][5]
    want = ("seq_parallel" if strategy == "auto" and arch in SEQ_PARALLEL
            else "tp")
    assert port["strategy"] == want
    pre, dec = port["placements"][:2]
    assert pre == _policy(case, port["caches"][0], "prefill", want)
    assert dec == _policy(case, port["caches"][1], "decode", "tp")
    if want == "seq_parallel":
        assert all(pl[1] == "S(2)" for p, pl in pre.items()
                   if p.split("/")[-1] in ("k", "v")), pre
    attention = any(k in ("global", "local")
                    for k in get_config(arch).layer_kinds)
    slot_split = [p for p, pl in dec.items()
                  if p.split("/")[-1] in KV_LEAVES and "S(2)" in pl]
    assert bool(slot_split) == attention, dec
    assert any(pl[0] != "R" for pl in dec.values()), dec     # over data
    assert any(pl[1] != "R" for pl in dec.values()), dec     # over model


@pytest.mark.parametrize("case", sorted(CASES))
def test_weights_placed_once_where_the_sides_agree(case):
    """Prefill and decode serve one placed tree of weights where their
    rules lay it out alike (tensor-parallel prefill), and two where they
    do not (sequence-parallel prefill keeps the heads whole)."""
    port, _ = served()[case]
    assert port["shared_weights"] == (port["strategy"] == "tp")


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_keeps_the_cache_placements(case):
    port, _ = served()[case]
    pls = port["placements"]
    assert len(pls) == GEN + 2
    for i, pl in enumerate(pls[2:]):
        assert pl == pls[1], f"step {i}"


# ---------------------------------------------------------------------------
# Units on 4 ranks
# ---------------------------------------------------------------------------

# decode attention: (kv positions, placements of the (K, B, S, KV, hd)
# cache); the slots over model, or over data x model
ATT = dict(b=2, s=12, h=4, kv=2, hd=16)
ATT_CASES = {
    "ring": ("ring", "batch_slots"),
    "empty_slots": ("empty", "batch_slots"),
    "rank_all_empty": ("first3", "slots4"),
    "per_row": ("per_row", "batch_slots"),
    "ring_slots4": ("ring", "slots4"),
}
LAYOUTS = {"batch_slots": ("S(1)", "S(2)"), "slots4": ("S(2)", "S(2)")}
WRITE_SLOTS = (0, 5, 7)              # 8 slots over 4 ranks: ranks 0, 2, 3
ROWS = dict(b=2, s=16)               # sequence-parallel rows: llama3.2-3b


def _att_inputs(case):
    rng = np.random.default_rng(3)
    a = ATT
    q = rng.standard_normal((a["b"], 1, a["h"], a["hd"])).astype(np.float32)
    k = rng.standard_normal((a["b"], a["s"], a["kv"], a["hd"])).astype(
        np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    kind, s = ATT_CASES[case][0], a["s"]
    idx = np.arange(s)
    if kind == "ring":            # slot order is not position order
        pos = np.array(jtfm._ring_positions(s, jnp.int32(29), 10))
    elif kind == "empty":         # slots 5.. empty: model rank 1's all
        pos = np.where(idx < 5, idx, -1).astype(np.int32)
    elif kind == "first3":        # only the first rank's slots filled
        pos = np.where(idx < 3, idx, -1).astype(np.int32)
    else:                         # (B, S): each row its own filled slots
        pos = np.stack([np.where(idx < n, idx, -1)
                        for n in (2, 9)]).astype(np.int32)
    return q, k, v, pos


def _placements(names):
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if n == "R" else Shard(int(n[2:-1])) for n in names]


def _units_rank(rank, world_size):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.configs import reduce_for_smoke
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import ShardCtx, from_numpy_params
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm

    mesh = make_debug_mesh(2, 2, device_type="cpu")
    ctx = ShardCtx(mesh, sh.act_rules(get_config("olmo-1b"), "decode",
                                      False))
    rep = [Replicate(), Replicate()]
    out = {"attention": {}, "writes": {}}
    for case, (_kind, layout) in ATT_CASES.items():
        q, k, v, pos = (torch.from_numpy(x) for x in _att_inputs(case))
        pl = _placements(LAYOUTS[layout])
        kc, vc = (distribute_tensor(t[None], mesh, pl, src_data_rank=None)
                  for t in (k, v))
        dq = distribute_tensor(q, mesh, rep, src_data_rank=None)
        o = attn.cached_attention(dq, kc, vc, pos, ctx)
        out["attention"][case] = o.full_tensor().numpy()

    # the slot write: 8 slots over data x model
    rng = np.random.default_rng(4)
    for slot in WRITE_SLOTS:
        full = torch.from_numpy(rng.standard_normal((1, 2, 8, 2, 4)).astype(
            np.float32))
        val = torch.from_numpy(rng.standard_normal((1, 2, 1, 2, 4)).astype(
            np.float32))
        dst = distribute_tensor(full, mesh, _placements(("S(2)", "S(2)")),
                                src_data_rank=None)
        before = dst.to_local().clone()
        tfm._write_slot(dst, val, torch.tensor(slot, dtype=torch.int32), ctx)
        changed = sorted({int(i) for i in torch.nonzero(
            (dst.to_local() != before).any(-1).any(-1))[:, 2]})
        mine = [None] * world_size
        dist.all_gather_object(mine, changed)
        want = full.clone()
        want[:, :, slot] = val[:, :, 0]
        out["writes"][slot] = (mine, bool(torch.equal(dst.full_tensor(),
                                                      want)))

    # sequence-parallel attention: each rank's query rows
    cfg = reduce_for_smoke(get_config("llama3.2-3b"))
    cfg = dataclasses.replace(cfg, attn_block_q=0)
    jcfg, _ = configs("llama3.2-3b")
    p = from_numpy_params(first_layer(reference_weights(jcfg, 2), "p0")[
        "attn"], device="cpu")
    p = {k_: t[None] for k_, t in p.items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, ROWS["b"], ROWS["s"], cfg.d_model)).astype(np.float32))
    sctx = ShardCtx(mesh, sh.act_rules(get_config("llama3.2-3b"), "prefill",
                                       False, "seq_parallel"))
    seen, real = [], attn.blockwise_attention

    def spy(qq, kk, vv, **kw):
        seen.append((tuple(qq.shape), tuple(kk.shape), kw.get("q_offset")))
        return real(qq, kk, vv, **kw)
    attn.blockwise_attention = spy
    try:
        with sctx.scope(), torch.no_grad():
            o, _k, _v = attn.attention_layer(
                p, sctx.constrain(distribute_tensor(
                    x, mesh, rep, src_data_rank=None), tfm.X_AXES),
                cfg, "global", ctx=sctx)
    finally:
        attn.blockwise_attention = real
    calls = [None] * world_size
    dist.all_gather_object(calls, seen)
    out["rows"] = (o.full_tensor().numpy() if isinstance(o, DTensor)
                   else o.numpy(), calls)
    return out


def units():
    return _worlds()[1]


@pytest.mark.parametrize("case", sorted(ATT_CASES))
def test_slot_sharded_decode_attention_matches_reference(case):
    """Each rank's partial softmax over its own slots, merged over the
    mesh dims that split them, is the reference's ``decode_attention``;
    ranks with no filled slot add nothing (and no NaN)."""
    q, k, v, pos = _att_inputs(case)
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v, pos)))
    got = units()["attention"][case]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("slot", WRITE_SLOTS)
def test_slot_write_lands_on_one_rank(slot):
    """8 slots over data x model, 2 a rank: only the rank holding the
    slot changes its shard, at the slot's local index."""
    changed, whole = units()["writes"][slot]
    owner = slot // 2
    assert changed == [[slot % 2] if r == owner else []
                       for r in range(4)], changed
    assert whole


def test_sequence_parallel_attention_runs_each_rank_s_rows():
    """Under seq_parallel (llama3.2-3b's prefill rules) the queries stay
    split over ``model``: each rank's blockwise call takes its S/2 query
    rows at ``q_offset`` = its model coordinate x S/2, against the whole
    sequence's keys; the output is the reference's attention block."""
    o, calls = units()["rows"]
    half = ROWS["s"] // 2
    for rank, seen in enumerate(calls):
        assert seen, rank
        for qs, ks, off in seen:
            assert qs[1] == half and ks[1] == ROWS["s"], (rank, seen)
            assert off == (rank % 2) * half, (rank, seen)
    jcfg, _ = configs("llama3.2-3b")
    p = first_layer(reference_weights(jcfg, 2), "p0")["attn"]
    x = np.random.default_rng(5).standard_normal(
        (1, ROWS["b"], ROWS["s"], jcfg.d_model)).astype(np.float32)
    want = jattn.attention_block(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x[0]), jcfg, kind="global")
    np.testing.assert_allclose(o[0], np.asarray(want), rtol=1e-4, atol=1e-5)
