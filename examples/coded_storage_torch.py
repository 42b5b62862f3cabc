"""Coded computing walkthrough (paper Sec 3.3) on the PyTorch port:
Lagrange-encode a round of per-shard parameters into client slices, then
reconstruct under (a) full availability, (b) erasures (clients offline),
(c) Byzantine corruption — showing the eq. (11) tolerance in action.  On
the CUDA card (the default; ``--device cpu`` for the CPU) the encode and
the decodes run the ``coded_matmul`` kernel; the reference's
``use_kernel=True`` has no counterpart, since the tensor's device decides.
Prints the lines of ``examples/coded_storage.py`` in its order.

    PYTHONPATH=src python examples/coded_storage_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import coding
from repro_torch.kernels import resolve_device

AVAILABLE = [0, 4, 9, 15, 18, 23]
BYZANTINE = [2, 11, 19]


def run(num_clients: int = 24, num_shards: int = 4, width: int = 100_000,
        device=None) -> dict:
    """Encode (S, P) seeded shard vectors into C slices and decode them
    three ways; returns the tensors and every number ``main`` prints."""
    dev = resolve_device(device)
    c, s, p = num_clients, num_shards, width
    scheme = coding.CodingScheme(num_shards=s, num_clients=c)
    rng = np.random.default_rng(0)
    shard_params = torch.from_numpy(
        rng.standard_normal((s, p)).astype(np.float32)).to(dev)

    def err(rec):
        return float((rec - shard_params).abs().max())

    slices = coding.encode(scheme, shard_params)
    ids = [1, 7, 13, 22]
    rec_a = coding.decode_erasure(
        scheme, slices.index_select(0, torch.tensor(ids, device=dev)), ids)
    rec_b = coding.decode_erasure(
        scheme, slices.index_select(0, torch.tensor(AVAILABLE, device=dev)),
        AVAILABLE)
    corrupted = slices.cpu().numpy().copy()
    corrupted[BYZANTINE] += rng.standard_normal((len(BYZANTINE), p)) * 10
    rec_c, located = coding.decode_with_errors(
        scheme, torch.from_numpy(corrupted).to(dev))
    return {"scheme": scheme, "shard_params": shard_params, "slices": slices,
            "decoded": {"a": rec_a, "b": rec_b, "c": rec_c},
            "err": {"a": err(rec_a), "b": err(rec_b), "c": err(rec_c)},
            "located": [int(i) for i in located]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    scheme, slices = out["scheme"], out["slices"]
    s, c = scheme.num_shards, scheme.num_clients

    print(f"== encode: S={s} shard vectors -> C={c} coded client slices ==")
    print(f"   slice matrix: {tuple(slices.shape)}, "
          f"server stores only the {c} interpolation keys")
    print(f"   error tolerance (eq. 11): up to {scheme.max_errors} "
          f"corrupted slices")
    print("== (a) decode from any S slices ==")
    print(f"   max |error| = {out['err']['a']:.2e}")
    print(f"== (b) erasures: only {len(AVAILABLE)} of {c} clients reachable "
          f"==")
    print(f"   max |error| = {out['err']['b']:.2e}")
    print(f"== (c) corruption: {len(BYZANTINE)} Byzantine clients send "
          f"garbage ==")
    print(f"   Berlekamp-Welch located bad clients: {out['located']} "
          f"(truth: {BYZANTINE})")
    print(f"   max |error| = {out['err']['c']:.2e}")
    return out


if __name__ == "__main__":
    main()
