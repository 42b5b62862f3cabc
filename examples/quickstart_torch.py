"""Quickstart on the PyTorch port: the paper's full loop, on the
experiment API, on the CUDA card unless ``--device cpu`` is given.

One ``ScenarioConfig`` describes the federation; ``FederatedSession`` trains
the paper's CNN across isolated shards with coded parameter storage (the
``coded_matmul`` kernel encodes and decodes the slices), serves an
unlearning request with SE (the ``calibrate`` kernel runs eq. 3) and the FR
gold standard for comparison, and a membership-inference attack checks the
victim is actually forgotten.  Prints the lines of
``examples/quickstart.py`` in its order.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.fl.experiment import (ScenarioConfig, UnlearnRequest,
                                       build_session)
from repro_torch.fl.mia import mia_f1


def config(**overrides) -> ScenarioConfig:
    """The reference example's scenario (``overrides`` cut it for tests)."""
    base = dict(task="classification", num_clients=12, clients_per_round=8,
                num_shards=2, local_epochs=4, global_rounds=5,
                samples_per_client=100, image_size=14, test_n=400,
                store="coded")
    base.update(overrides)
    return ScenarioConfig(**base)


def run(cfg: ScenarioConfig, device=None, init_fn=None) -> dict:
    """Train one stage, unlearn its first shard-0 client with SE and FR,
    attack the SE models; returns every number ``main`` prints, the stage
    record and the unlearning results."""
    session, (test_x, test_y) = build_session(cfg, device=device,
                                              init_fn=init_fn)
    sim = session.sim
    record = session.run_stage()
    out = {"record": record,
           "base": sim.evaluate(record.shard_models, test_x, test_y),
           "store_stats": record.store.stats.to_dict()}
    victim = record.plan.shard_clients[0][0]
    out["victim"], out["unlearn"] = victim, {}
    for fw in ("SE", "FR"):
        res = session.unlearn(UnlearnRequest([victim], framework=fw))[0]
        out["unlearn"][fw] = {"result": res, **sim.evaluate(
            res.models, test_x, test_y)}

    res = session.unlearn(UnlearnRequest([victim], framework="SE"))[0]
    members = [c for c in record.plan.clients if c != victim][:4]
    mx = np.concatenate([sim.client_data[c][0][:40] for c in members])
    my = np.concatenate([sim.client_data[c][1][:40] for c in members])
    iface = sim.predict_interface()
    out["mia_result"] = res
    out["mia_f1"] = mia_f1(iface.stacked_predict, res.models,
                           iface.make_batch, iface.task, (mx, my),
                           (test_x, test_y), sim.client_data[victim])
    out["report"] = session.report.to_dict()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run(config(), device=args.device)

    print("== train: 2 isolated shards, coded parameter store ==")
    print(f"   shard-ensemble accuracy: {out['base']['acc']:.3f}")
    st = out["store_stats"]
    print(f"   server storage: {st['server_bytes']} B (keys only); "
          f"coded slices on clients: {st['client_bytes'] / 1e6:.1f} MB")
    print(f"== unlearn client {out['victim']} (shard 0) ==")
    for fw, m in out["unlearn"].items():
        res = m["result"]
        print(f"   {fw:3s}: acc={m['acc']:.3f}  cost={res.cost_units:.0f} "
              f"client-epochs  wall={res.wall_time:.1f}s  "
              f"impacted_shards={res.impacted_shards}")
    print("== membership-inference attack on the forgotten client ==")
    print(f"   attack F1 = {out['mia_f1']:.3f} (lower = better forgotten)")
    print("== session report (JSON excerpt) ==")
    report = out["report"]
    print(f"   stages={report['num_stages']} "
          f"train_wall={report['total_train_wall_s']:.1f}s "
          f"unlearn_wall={report['total_unlearn_wall_s']:.1f}s "
          f"cost_units={report['total_cost_units']:.0f}")
    return out


if __name__ == "__main__":
    main()
