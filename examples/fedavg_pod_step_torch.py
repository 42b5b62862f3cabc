"""The production FedAvg / unlearning steps of the PyTorch port on a
reduced architecture: the same steps ``chip_smoke.py`` drives at rwkv6-3b's
published width (client-serial FedAvg rounds with an adamw server, then
one eq. 3 calibration round), through ``repro_torch.launch.train``.  Runs
on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/fedavg_pod_step_torch.py \
        [--arch granite-moe-1b-a400m] [--rounds 6] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import (FLConfig, OptimizerConfig, get_config,
                                 reduce_for_smoke)
from repro_torch.kernels import resolve_device
from repro_torch.launch.train import (demo_batch, make_calibration_step,
                                      make_fedavg_step)
from repro_torch.models import init_params
from repro_torch.optim import init_optimizer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduce_for_smoke(get_config(args.arch))
    fl = FLConfig(fl_clients_per_step=4, fl_local_steps=2)
    opt = OptimizerConfig(name="adamw", lr=2e-3)
    params = init_params(cfg, 0, device=dev)
    state = (params, init_optimizer(opt, params))

    step = make_fedavg_step(cfg, fl, opt)
    rng = np.random.default_rng(0)

    def make_batch():
        return demo_batch(cfg, rng, 4, 2, 64, dev)

    print(f"== {args.rounds} FedAvg rounds ({cfg.name}, 4 clients x 2 local "
          f"steps, on {dev}) ==")
    norms = []
    for i in range(args.rounds):
        state, mets = step(state, make_batch())
        norms.append(float(mets["delta_norm"]))
        print(f"   round {i}: loss={float(mets['loss']):.4f} "
              f"|mean delta|={norms[-1]:.4f}")

    print("== one calibrated retraining round (eq. 3) ==")
    cal = make_calibration_step(cfg, fl)
    stored_norms = torch.full((4,), norms[-1], device=dev)
    _new_params, mets = cal(state[0], make_batch(), stored_norms)
    print(f"   calibration loss={float(mets['loss']):.4f} "
          f"(delta rescaled to historical norms)")


if __name__ == "__main__":
    main()
