#!/usr/bin/env python3
"""Time the window-attention forward against each design choice its notes
weigh, removed or extended, on one GPU:
``python3 tools/wattn_fwd_alternatives.py``.

Builds ``src/repro_torch/kernels/csrc/window_attn.cu`` as it stands and with
the overrides it reads from the compiler's defines (the source is not
edited):

* ``one_tile_blocks`` (``WATTN_FWD_SLOTS=1``) — every block owns one query
  head's tile: no two query heads share K and V;
* ``two_tile_blocks`` (``WATTN_FWD_SLOTS=2``) — two query heads a block
  wherever H / KV is even, also where that grid leaves SMs idle;
* ``no_split_tiles`` (``WATTN_FWD_SPLIT=0``) — no block splits K and V
  tiles once: every warp splits its own fragments;
* ``split_tiles`` (``WATTN_FWD_SPLIT=1``) — one-head blocks split K and V
  tiles once too;
* ``no_hdp32`` (``WATTN_FWD_HDP32=0``) — hd <= 32 runs at the width 64.

Each library's forward is checked against the plain version
(|k - r| <= 1e-5 + 1e-4|r|) and timed by ``chip_smoke.timed`` (CUPTI,
checked against CUDA events) at the cases of ``chip_smoke.check_window``;
prints each variant's forward kernels' registers and spills, then one JSON
line a case, with the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/window_attn.cu"
OUT = ROOT / "build" / "wattn_fwd_alternatives"
VARIANTS = {"committed": [],
            "one_tile_blocks": ["-DWATTN_FWD_SLOTS=1"],
            "two_tile_blocks": ["-DWATTN_FWD_SLOTS=2"],
            "no_split_tiles": ["-DWATTN_FWD_SPLIT=0"],
            "split_tiles": ["-DWATTN_FWD_SPLIT=1"],
            "no_hdp32": ["-DWATTN_FWD_HDP32=0"]}


def build() -> dict:
    import chip_smoke as cs
    from repro_torch import kernels as K
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in VARIANTS.items():
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, *defines, "-shared", str(SRC),
             "-o", str(OUT / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_float)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        print(json.dumps({"variant": name, "ptxas": [
            r for r in cs.ptxas_summary(log) if "wattn_fwd_kernel" in r[0]]}),
            flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.repro_window_attn_fwd.argtypes = ([ptr] * 5 + [i64] * 6 + [f32]
                                              + [i64] * 9 + [ptr])
        lib.repro_window_attn_fwd.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.kernels.window_attn import ops
    from repro_torch.kernels.window_attn.ref import window_attention_ref
    K.resolve_device("cuda")
    print(cs.nvidia_smi(), flush=True)
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [("ragged", 2, 200, 4, 2, 64, 50, 20),
             ("hd128_window_ge_s", 1, 300, 4, 4, 128, 512, 20),
             ("window1", 2, 100, 4, 2, 64, 1, 20),
             ("ragged_hd27", 1, 130, 6, 3, 27, 70, 20),
             ("local_small", 4, 64, 4, 2, 16, 16, 50),
             ("gemma3_full_width", 2, 4096, 32, 16, 128, 1024, 5)]
    for label, b, s, h, kv, hd, window, iters in cases:
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device="cuda")
                   for n in (h, kv, kv))
        with torch.no_grad():
            want = window_attention_ref(q, k, v, window)
        row = {"case": label, "shape": [b, s, h, kv, hd, window]}
        for name, lib in libs.items():
            K.load_library = lambda lib=lib: lib
            with torch.no_grad():
                err = cs.compare(ops._fwd(q, k, v, window)[0], want,
                                 f"{name}/{label}", 1e-4, 1e-5)
                t = cs.timed(lambda: ops._fwd(q, k, v, window), iters,
                             batch=True)
            row[name] = {"ms": t["ms"], "timer": t["timer"],
                         "event_ms": t["event_ms"],
                         "max_abs_err": err["max_abs_err"]}
        print(json.dumps(row), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
