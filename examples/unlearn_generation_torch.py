"""Generation unlearning on a non-transformer family with the PyTorch port:
RWKV-6 through the ``wkv`` kernels (forward and backward) on the CUDA
card unless ``--device cpu`` is given.

The scenario registries make this a config, not a code path: pick
``task="generation"``, ``model="rwkv6"``, and a Zipf quantity-skew
partitioner, and the same ``FederatedSession`` -> coded store
(``coded_matmul``) -> SE (``calibrate``) machinery the paper validated on
NanoGPT runs an attention-free SSM, with perplexity / bits-per-char eval.
Prints the lines of ``examples/unlearn_generation.py`` in its order.

    PYTHONPATH=src python examples/unlearn_generation_torch.py [--device cpu]
"""
import argparse

from repro_torch.fl.experiment import (ScenarioConfig, UnlearnRequest,
                                       build_session)


def config(**overrides) -> ScenarioConfig:
    """The reference example's scenario (``overrides`` cut it for tests)."""
    base = dict(task="generation", model="rwkv6", partitioner="zipf",
                partitioner_kwargs={"exponent": 1.0}, num_clients=10,
                clients_per_round=8, num_shards=2, local_epochs=2,
                global_rounds=3, samples_per_client=12, seq_len=24,
                test_n=60, local_batch=4, store="coded")
    base.update(overrides)
    return ScenarioConfig(**base)


def run(cfg: ScenarioConfig, device=None, init_fn=None) -> dict:
    """Train one stage and serve one SE request on its first shard-0
    client; returns every number ``main`` prints, the stage record and the
    SE result."""
    session, (test_x, test_y) = build_session(cfg, device=device,
                                              init_fn=init_fn)
    sim = session.sim
    record = session.run_stage()
    base = sim.evaluate(record.shard_models, test_x, test_y)
    sizes = {c: len(sim.client_data[c][0]) for c in record.plan.clients}
    victim = record.plan.shard_clients[0][0]
    res = session.unlearn(UnlearnRequest([victim], framework="SE"))[0]
    return {"record": record, "base": base, "sizes": sizes,
            "victim": victim, "se": res,
            "after": sim.evaluate(res.models, test_x, test_y)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run(config(), device=args.device)
    base, after, res = out["base"], out["after"], out["se"]

    print("== train: rwkv6 family, 2 isolated shards, coded store ==")
    print(f"   ensemble: ppl={base['ppl']:.1f}  bpc={base['bpc']:.2f}  "
          f"acc={base['acc']:.3f}")
    print(f"   zipf quantity skew — per-client examples: {out['sizes']}")
    print(f"== SE unlearn client {out['victim']} (shard 0 retrains, shard 1 "
          f"untouched) ==")
    print(f"   SE : ppl={after['ppl']:.1f}  bpc={after['bpc']:.2f}  "
          f"cost={res.cost_units:.0f} client-epochs  "
          f"wall={res.wall_time:.1f}s  impacted={list(res.impacted_shards)}")
    return out


if __name__ == "__main__":
    main()
