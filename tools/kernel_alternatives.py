#!/usr/bin/env python3
"""Time ``encode_decode`` and the ``ssm_scan`` forward against another
version of their sources on one GPU: ``python3
tools/kernel_alternatives.py [--parent DIR]``.

Builds ``src/repro_torch/kernels/csrc/coded_matmul.cu`` and ``ssm_scan.cu``
as they stand and, with ``--parent DIR``, the same two files of another
checkout's ``kernels/csrc`` (``git archive <commit>
src/repro_torch/kernels/csrc | tar -x -C build/parent``, then ``--parent
build/parent/src/repro_torch/kernels/csrc``; ``build/`` is git-ignored).

``encode_decode`` runs at each federated path's ``all_clients`` shape (S 4,
C 20 and the path's P, the coding scheme's operators) and at
``benchmarks/kernels_bench.py``'s (C 100, S 4, P 500,000), fp32 and with bf16
w; ``ssm_scan`` at jamba's serve prefill (4, 512, 16384, 16) and the mamba
path's stage (50, 64, 64, 8, 5 groups), fp32 and bf16 inputs.  Every
variant is held against the plain version (``chip_smoke.compare``'s
tolerances), two launches bit-identical, a bf16 call bit for bit the fp32
call on the widened operands; each case is timed by ``chip_smoke.timed``
(CUPTI, checked against CUDA events) in turns, variants in order then in
reverse, both readings printed.  Beside ``encode_decode``:
``torch.linalg.multi_dot([dec, enc, w])`` and ``torch.matmul(dec,
torch.matmul(enc, w))`` (the kernel's order).  Prints the card's name and
power limit, each library's registers and spills, then one JSON line a
case.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build" / "kernel_alternatives"


def variants(parent: Path | None) -> dict:
    out = {"coded_matmul": SRC / "coded_matmul.cu",
           "ssm_scan": SRC / "ssm_scan.cu"}
    if parent is not None:
        out["parent_coded_matmul"] = parent / "coded_matmul.cu"
        out["parent_ssm_scan"] = parent / "ssm_scan.cu"
    return out


def build(parent: Path | None) -> dict:
    import chip_smoke as cs
    from repro_torch import kernels as K
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants(parent).items():
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-shared", str(src),
             "-o", str(OUT / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        print(json.dumps({"variant": name, "ptxas": [
            r for r in cs.ptxas_summary(log)
            if "encode_decode_kernel" in r[0] or "ssm_fwd_kernel" in r[0]]}),
            flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        if "coded_matmul" in name:
            lib.repro_encode_decode.argtypes = [ptr] * 4 + [i64] * 3 + \
                [i32] * 4 + [ptr]
            lib.repro_encode_decode.restype = i32
        else:
            lib.repro_ssm_scan_fwd.argtypes = [ptr] * 9 + [i64] * 5 + \
                [i32, ptr]
            lib.repro_ssm_scan_fwd.restype = i32
            lib.repro_ssm_scan_ckpt_steps.argtypes = []
            lib.repro_ssm_scan_ckpt_steps.restype = i32
        libs[name] = lib
    return libs


def in_turns(torch, K, cs, libs: dict, fn, iters: int) -> dict:
    """Each variant's time of ``fn`` by ``cs.timed``, in order, then in
    reverse: {variant: [first reading, second reading]}."""
    names = list(libs)
    got = {n: [] for n in names}
    for n in names + names[::-1]:
        K.load_library = lambda lib=libs[n]: lib
        got[n].append(cs.timed(fn, iters, batch=True)["ms"])
    return got


def encode_decode_cases(torch, K, cs, libs: dict) -> None:
    from repro_torch.core import coding
    from repro_torch.kernels.coded_matmul.ops import coded_encode_decode
    from repro_torch.kernels.coded_matmul.ref import coded_encode_decode_ref
    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = [(f"all_clients_{path}", 20, cs.PATHS[path]["p_client"], 200)
             for path in cs.PATHS]
    cases.append(("bench_c100_s4", 100, 500_000, 50))
    for label, c, p, iters in cases:
        sch = coding.CodingScheme(4, c)
        enc, dec = (torch.tensor(m, dtype=torch.float32, device="cuda")
                    for m in coding.encode_decode_operators(sch, None))
        w32 = torch.randn(4, p, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            w = w32.to(dtype)
            want = coded_encode_decode_ref(enc, dec, w)
            row = {"kernel": "encode_decode", "case": label, "shape": [c, 4, p],
                   "w_dtype": str(dtype)}
            for name, lib in libs.items():
                K.load_library = lambda lib=lib: lib
                got = coded_encode_decode(enc, dec, w)
                if not torch.equal(got, coded_encode_decode(enc, dec, w)):
                    raise AssertionError(f"{name}/{label}: two launches "
                                         f"differ")
                if dtype == torch.bfloat16 and not torch.equal(
                        got, coded_encode_decode(enc, dec, w.float())):
                    raise AssertionError(f"{name}/{label}: bf16 w is not "
                                         f"the fp32 call on widened w")
                row[f"{name}_max_abs_err"] = cs.compare(
                    got, want, f"{name}/{label}")["max_abs_err"]
            row.update(in_turns(torch, K, cs, libs,
                                lambda: coded_encode_decode(enc, dec, w),
                                iters))
            if dtype == torch.float32:
                row["multi_dot_ms"] = cs.timed(
                    lambda: torch.linalg.multi_dot([dec, enc, w]), iters)["ms"]
                row["matmul_same_order_ms"] = cs.timed(
                    lambda: torch.matmul(dec, torch.matmul(enc, w)),
                    iters)["ms"]
            print(json.dumps(row), flush=True)
        del enc, dec, w32, w, want
        torch.cuda.empty_cache()


def ssm_cases(torch, K, cs, libs: dict) -> None:
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(32)
    for label, bsz, s, d, n, g, iters in (
            ("serve_jamba", 4, 512, 16384, 16, 1, 5),
            ("fused_stage", 50, 64, 64, 8, 5, 50)):
        args = cs.ssm_inputs(torch, gen, bsz, s, d, n, g)
        with torch.no_grad():
            want = ssm_scan_ref(*args)
            half = [t.to(torch.bfloat16) for t in args[:4]] + args[4:]
            wide = cs._widened(torch, half)
            want16 = ssm_scan_ref(*half)
            for dtype, a, ref in ((torch.float32, args, want),
                                  (torch.bfloat16, half, want16)):
                row = {"kernel": "ssm_scan", "case": label,
                       "shape": [bsz, s, d, n, g], "dtype": str(dtype)}
                for name, lib in libs.items():
                    K.load_library = lambda lib=lib: lib
                    y, hl = ops.ssm_scan(*a)
                    again = ops.ssm_scan(*a)
                    if not cs._same(torch, (y, hl), again):
                        raise AssertionError(f"{name}/{label}: two launches "
                                             f"differ")
                    if dtype == torch.bfloat16 and not cs._same(
                            torch, (y, hl), ops.ssm_scan(*wide)):
                        raise AssertionError(f"{name}/{label}: bf16 is not "
                                             f"the fp32 call on the widened "
                                             f"inputs")
                    row[f"{name}_max_abs_err"] = cs.compare(
                        y, ref[0], f"{name}/{label}", 2e-4,
                        2e-4)["max_abs_err"]
                row.update(in_turns(torch, K, cs, libs,
                                    lambda: ops.ssm_scan(*a), iters))
                print(json.dumps(row), flush=True)
        del args, want, half, wide, want16
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's kernels/csrc to time beside")
    opts = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import kernels as K
    K.resolve_device("cuda")
    print(cs.nvidia_smi(), flush=True)
    libs = build(opts.parent)
    encode_decode_cases(torch, K, cs, {k: v for k, v in libs.items()
                                       if "coded_matmul" in k})
    ssm_cases(torch, K, cs, {k: v for k, v in libs.items()
                             if "ssm_scan" in k})
    return 0


if __name__ == "__main__":
    sys.exit(main())
