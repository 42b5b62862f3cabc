#!/usr/bin/env python3
"""Time the window-attention forward against each design choice its notes
weigh, removed or extended, on one GPU:
``python3 tools/wattn_fwd_alternatives.py [--bf16-tma [--against DIR]]``.

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

``--bf16-tma`` builds the bf16 wgmma / TMA forward
(``window_attn_tma.cu``, its C entry called directly) as it stands and,
with ``--against DIR``, the same file of another checkout (a ``git
archive`` of another commit unpacked in DIR), and holds each to the plain
version (2^-8 (max|v| + |r|)) at gemma3-27b's layer, on strided views of a
fused projection and at the small window-1 case, timing them in turns, in
order and then in reverse, both readings printed.
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


TMA_SRC = "src/repro_torch/kernels/csrc/window_attn_tma.cu"


def build(tma: bool = False, against=None) -> dict:
    import chip_smoke as cs
    from repro_torch import kernels as K
    OUT.mkdir(parents=True, exist_ok=True)
    if tma:
        # name -> (source, defines): this checkout's file and another's
        todo = {"tma": (ROOT / TMA_SRC, [])}
        if against is not None:
            todo["tma_against"] = (Path(against).resolve() / TMA_SRC, [])
    else:
        todo = {name: (SRC, d) for name, d in VARIANTS.items()}
    procs = {}
    for name, (src, defines) in todo.items():
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, *defines, "-shared", str(src),
             "-o", str(OUT / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_float)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        kernel = "wattn_fwd_bf16_tma_kernel" if tma else "wattn_fwd_kernel"
        print(json.dumps({"variant": name, "ptxas": [
            r for r in cs.ptxas_summary(log) if kernel in r[0]],
            "wgmma_notes": [ln.strip()[:200] for ln in log.splitlines()
                            if "C75" in ln]}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fn = lib.repro_window_attn_fwd_bf16_tma if tma else \
            lib.repro_window_attn_fwd
        fn.argtypes = [ptr] * 5 + [i64] * 6 + [f32] + [i64] * 9 + [ptr]
        fn.restype = i32
        libs[name] = fn
    return libs


def tma_main(torch, K, cs, against) -> int:
    """``--bf16-tma``: the wgmma forward, and another checkout's, at
    gemma3-27b's layer, on fused-projection views and at window 1."""
    from repro_torch.kernels.window_attn import ops
    from repro_torch.kernels.window_attn.ref import window_attention_ref
    libs = build(tma=True, against=against)
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf = torch.bfloat16

    def fwd(fn, q, k, v, window):
        b, s, h, hd = q.shape
        o = torch.empty((b, s, h, hd), dtype=bf, device="cuda")
        lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
        K.check_launch(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), b, s, h, k.shape[2],
                          hd, window, hd ** -0.5, *ops._strides(q, k, v),
                          K.stream_of(q)), "window_attention_bf16")
        return o
    for label, b, s, h, kv, hd, window, iters, fused in (
            ("gemma3_full_width_bf16", 2, 4096, 32, 16, 128, 1024, 5, False),
            ("fused_qkv_views_bf16", 2, 2048, 8, 4, 128, 512, 10, True),
            ("window1_bf16", 2, 100, 4, 2, 64, 1, 20, False)):
        if fused:
            x = torch.randn(b, s, (h + 2 * kv) * hd, generator=gen,
                            device="cuda").to(bf)
            q = x[..., :h * hd].unflatten(-1, (h, hd))
            k = x[..., h * hd:(h + kv) * hd].unflatten(-1, (kv, hd))
            v = x[..., (h + kv) * hd:].unflatten(-1, (kv, hd))
        else:
            q, k, v = (torch.randn(b, s, n, hd, generator=gen,
                                   device="cuda").to(bf) for n in (h, kv, kv))
        row = {"case": label, "shape": [b, s, h, kv, hd, window]}
        with torch.no_grad():
            want = window_attention_ref(q, k, v, window).float()
            tol = 2.0 ** -8 * (float(v.float().abs().max()) + want.abs())
            for name in libs:
                got = fwd(libs[name], q, k, v, window).float()
                if not bool(((got - want).abs() <= tol).all()):
                    raise AssertionError(f"{name}/{label}: past 2^-8 "
                                         f"(max|v| + |r|) of the plain "
                                         f"version")
                row[f"{name}_max_abs_err"] = float((got - want).abs().max())
            del want, tol, got
            names = list(libs)
            times = {n: [] for n in names}
            for n in names + names[::-1]:
                times[n].append(cs.timed(
                    lambda fn=libs[n]: fwd(fn, q, k, v, window), iters,
                    batch=True)["ms"])
        row.update(times)
        print(json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


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
    args = sys.argv[1:]
    if "--bf16-tma" in args:
        against = args[args.index("--against") + 1] \
            if "--against" in args else None
        return tma_main(torch, K, cs, against)
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
