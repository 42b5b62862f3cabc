"""The published bf16 numerics in the PyTorch port against the reference
on the CPU, part two (``tests/test_torch_bf16.py`` holds the training
steps and the shared helpers): serving (prefill and four
teacher-forced decode steps) on each decoder arch
``tests/test_torch_serve.py`` covers, held to twice the reference's one-ulp
spread as there; ``ssm_chunk_dtype="bfloat16"`` against the reference's
bf16-chunk output within the reference's own 0.05; the dry run's
``--profile``; bf16 weights through ``from_numpy_params`` /
``to_numpy_params``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import (SERVE_ARCHS, SERVE_REF, assert_within_spread,
                             configs, port_serve, reference_serve,
                             reference_weights, serve_batch, serve_spread)

from repro.configs import get_config as jget
from repro.configs import reduce_for_smoke as jreduce
from repro.models import mamba as jmb
from repro.models.params import RealInit as JRealInit
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import dryrun
from repro_torch.models import from_numpy_params, to_numpy_params
from repro_torch.models.mamba import mamba_block

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_bf16_serving_matches_reference(arch):
    jcfg, tcfg = configs(arch, SERVE_REF.get(arch))
    got = port_serve(tcfg, reference_weights(jcfg), *serve_batch(jcfg))
    assert_within_spread(got, reference_serve(jcfg), serve_spread(jcfg),
                         (arch, "serve"))


# ------------------------------------------------- ssm_chunk_dtype, profile

def test_bf16_ssm_chunks_match_reference_bound():
    """``ssm_chunk_dtype="bfloat16"``: the port (whose scan keeps its state
    in fp32 registers, the option's chunk tensors never reaching device
    memory) against the reference's bf16-chunk output, within the
    reference's own bound of its bf16 chunks against fp32
    (tests/test_perf_variants.py: 0.05 relative to the output's largest
    entry), on that test's shapes; and bit for bit the port's float32
    option."""
    cfg = jreduce(jget("jamba-1.5-large-398b"))
    cfg16 = dataclasses.replace(cfg, ssm_chunk_dtype="bfloat16")
    jp = jmb.init_mamba(JRealInit(jax.random.key(0), jnp.float32), cfg)
    x = jax.random.normal(jax.random.key(2), (2, 128, cfg.d_model),
                          jnp.float32) * 0.5
    want, _ = jmb.mamba_block(jp, x, cfg16)
    tcfg = dataclasses.replace(reduce_for_smoke(
        get_config("jamba-1.5-large-398b")), ssm_chunk_dtype="bfloat16")
    tp = tree_map(lambda v: v.unsqueeze(0),
                  from_numpy_params(jax.tree.map(np.asarray, jp),
                                    device="cpu"))
    tx = torch.from_numpy(np.array(x))[None]
    got, _ = mamba_block(tp, tx, tcfg)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got[0].detach().numpy() - want).max())
    assert err < 0.05 * (np.abs(want).max() + 1e-6), err
    f32, _ = mamba_block(tp, tx, dataclasses.replace(
        tcfg, ssm_chunk_dtype="float32"))
    assert torch.equal(got, f32)


def _reference_profiles():
    """``repro.launch.dryrun.PROFILES``.  Importing the reference's dry run
    sets ``XLA_FLAGS`` (512 host devices) for backends not yet started:
    start this process's first, then give the variable back (as
    tests/test_torch_dryrun.py does)."""
    import os
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import PROFILES
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return PROFILES


def test_dryrun_profiles_are_the_reference_profiles(tmp_path):
    """``PROFILES`` equal the reference's; ``--profile optimized`` gives its
    overrides (in the record and the config counted) and its "auto"
    strategy, and writes the reference's ``_opt`` file name; the
    reference's ``--multi-pod`` and ``--both-meshes`` map onto the
    port's meshes with the same record keys."""
    J_PROFILES = _reference_profiles()
    assert dryrun.PROFILES == J_PROFILES
    rec = dryrun.run_one("jamba-1.5-large-398b", "prefill_32k", save=False,
                         mesh="16x16", collectives=False,
                         overrides=J_PROFILES["optimized"]["overrides"],
                         strategy=J_PROFILES["optimized"]["strategy"])
    assert rec["status"] == "ok", rec.get("error")
    assert rec["overrides"] == J_PROFILES["optimized"]["overrides"]
    assert rec["strategy"] in ("tp", "seq_parallel")
    base = dryrun.run_one("jamba-1.5-large-398b", "prefill_32k", save=False,
                          mesh="16x16", collectives=False)
    assert "overrides" not in base and base["strategy"] == "tp"
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k",
                        "--profile", "optimized", "--both-meshes",
                        "--no-collectives", "--out", str(tmp_path)]) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["olmo-1b_train_4k_16x16_opt.json",
                     "olmo-1b_train_4k_2x16x16_opt.json"]
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                        "--multi-pod", "--no-collectives", "--out",
                        str(tmp_path)]) == 0
    assert (tmp_path / "olmo-1b_decode_32k_2x16x16.json").exists()


def test_bf16_weights_round_trip_through_numpy():
    """``from_numpy_params`` takes the reference's bf16 arrays bit for bit;
    ``to_numpy_params`` gives them back widened to float32."""
    jcfg, _ = configs("olmo-1b")
    w = reference_weights(jcfg)
    tp = from_numpy_params(w, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    back = to_numpy_params(tp)
    for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(back)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
