"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain versions.

coded_matmul        — Lagrange encode / erasure decode: (C,S) @ (S,P).
coded_matmul_rounds — the all-rounds encode: (C,S) @ (G,S,P) -> (G,C,P).
calibrate           — eq. (3) accumulate: w + coeffs @ deltas.
ssm_scan            — the selective-SSM (mamba) scan, forward.
ssm_scan_bwd        — its backward (a reverse-time scan from the forward's
                      checkpoints + a fixed-order reduce over blocks and
                      sequences).
wkv                 — the RWKV-6 WKV recurrence, forward.
wkv_bwd             — its backward (a chunk-parallel forward sweep from the
                      checkpoints, one reverse walk with no recompute, and
                      a fixed-order reduce of du).
encode_decode       — the slice-verification round trip dec @ (enc @ w)
                      with the coded intermediate kept on chip.
window_attention    — causal sliding-window flash attention, forward.
window_attention_bwd — its backward (FlashAttention-2 form: one kernel
                      over query tiles for dQ, one over key tiles for dK
                      and dV).

The sources live in ``csrc/``.  ``load_library`` compiles them with ``nvcc``
(one process per source, started together) into one shared library with a
plain C interface under ``build/repro_torch/<hash of the sources>/`` at the
repository root, and loads it with ``ctypes``.  Nothing is built or imported
from CUDA when this module is imported.

Dispatch follows the tensor: a wrapper given CPU tensors runs the kernel's
plain PyTorch version (``ref.py``); given CUDA tensors it launches the
kernel, or raises.  Each launch adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Union

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last ``reset_launches``
LAUNCHES = {"coded_matmul": 0, "coded_matmul_rounds": 0, "calibrate": 0,
            "ssm_scan": 0, "ssm_scan_bwd": 0, "wkv": 0, "wkv_bwd": 0,
            "encode_decode": 0, "window_attention": 0,
            "window_attention_bwd": 0}

# last build's wall time and compiler output (``-Xptxas -v``)
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The counterpart of ``repro.kernels.on_tpu``: the device an entry point
    runs on.  ``None`` means the CUDA card, and raises when there is none —
    the CPU is used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               f"not available")
        # fp32 means fp32: cuDNN convolutions default to TF32, which keeps
        # about three decimal digits; the reference computes in full fp32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # the reference is bit-reproducible under a fixed seed, so two runs
        # on the card must be too: cuDNN may otherwise pick (or benchmark
        # its way to) convolution algorithms that sum in a different order
        # from one run to the next.
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; raises on a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel operands lie on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel operands on devices {sorted(kinds)}; expected "
                     f"all on one CUDA device or all on the CPU")


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "librepro_kernels.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{os.getpid()}"
        procs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = out_dir / f"{src.stem}.{tag}.o"
            procs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs = []
        for obj, proc in procs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                for _o, other in procs:
                    if other.poll() is None:
                        other.kill()
                        other.wait()
                raise RuntimeError(f"nvcc failed for {obj.stem}:\n{out}")
            objs.append(str(obj))
        tmp = out_dir / f"librepro_kernels.{tag}.so"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{log}")
        os.replace(tmp, so)
        for o in objs:
            os.remove(o)
    lib = ctypes.CDLL(str(so))
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_float)
    lib.repro_coded_matmul.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64,
                                       i32, i32, ptr]
    lib.repro_coded_matmul.restype = i32
    lib.repro_encode_decode.argtypes = [ptr] * 4 + [i64] * 3 + [i32, ptr]
    lib.repro_encode_decode.restype = i32
    lib.repro_calibrate.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, ptr]
    lib.repro_calibrate.restype = i32
    lib.repro_ssm_scan_fwd.argtypes = [ptr] * 9 + [i64] * 5 + [ptr]
    lib.repro_ssm_scan_fwd.restype = i32
    lib.repro_ssm_scan_bwd.argtypes = [ptr] * 15 + [i64] * 5 + [ptr]
    lib.repro_ssm_scan_bwd.restype = i32
    lib.repro_ssm_scan_bwd_workspace.argtypes = [i64] * 4
    lib.repro_ssm_scan_bwd_workspace.restype = i64
    lib.repro_ssm_scan_ckpt_steps.argtypes = []
    lib.repro_ssm_scan_ckpt_steps.restype = i32
    lib.repro_wkv_fwd.argtypes = [ptr] * 9 + [i64] * 5 + [ptr]
    lib.repro_wkv_fwd.restype = i32
    lib.repro_wkv_bwd.argtypes = [ptr] * 15 + [i64] * 5 + [ptr]
    lib.repro_wkv_bwd.restype = i32
    lib.repro_wkv_ckpt_steps.argtypes = []
    lib.repro_wkv_ckpt_steps.restype = i32
    lib.repro_window_attn_fwd.argtypes = ([ptr] * 5 + [i64] * 6 + [f32]
                                          + [i64] * 9 + [ptr])
    lib.repro_window_attn_fwd.restype = i32
    lib.repro_window_attn_bwd.argtypes = ([ptr] * 10 + [i64] * 6 + [f32]
                                          + [i64] * 9 + [ptr])
    lib.repro_window_attn_bwd.restype = i32
    BUILD_INFO.update(build_s=time.perf_counter() - t0, path=str(so),
                      log=log, built=bool(log))
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise on the ``cudaGetLastError()`` a C launcher returned."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
