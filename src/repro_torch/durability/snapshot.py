"""Versioned, checksummed snapshot format with atomic rename-commit
(``repro.durability.snapshot`` on torch).

One snapshot file holds one Python object graph: parameter trees of torch
tensors (any dtype, bf16 slices included) and numpy arrays, containers with
non-string keys, coding keys (``CodingScheme``), re-assembly specs
(``StackedRowSpec`` with its ``(shape, torch.dtype)`` row spec), dtypes
(``np.dtype`` and ``torch.dtype``), ``StoreStats`` and ``StagePlan``.  The
encoding is exact: a tensor is its raw bytes (``t.contiguous().cpu()``
viewed as ``torch.uint8``; the header keeps ``torch.<dtype>`` by name and
the shape), so nothing is promoted, and scalars ride in the JSON header
(Python's json round-trips finite floats exactly through repr).  No
``ml_dtypes`` is needed: a bf16 array is decoded by torch.

File layout, the reference's::

    MAGIC "REPROSN1" | u32 version | u64 header_len | u64 payload_len
    | u32 header_crc32 | u32 payload_crc32 | header JSON | array payload

``save_snapshot`` commits atomically: it writes ``<path>.tmp``, fsyncs it,
``os.replace``s it onto ``path`` and fsyncs the directory, so a crash
mid-write leaves at most the tmp file, never a half-written snapshot under
the committed name.  Every device-to-host copy is a blocking one, made
after the device is synchronized, so the bytes checksummed are the bytes
the tensor holds.  ``load_snapshot`` checks the magic, the declared
lengths and both checksums before decoding; a mismatch (torn write,
truncation, bit corruption) raises ``SnapshotCorruption``.  Tensors land
on ``device`` (the CPU when it is None, never the card unasked).
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import asdict

import numpy as np
import torch

from repro_torch.core import coding
from repro_torch.core.sharding import StagePlan
from repro_torch.stores.store import StoreStats

MAGIC = b"REPROSN1"
VERSION = 1
_FIXED = struct.Struct("<IQQII")       # version, hlen, plen, hcrc, pcrc

# numpy's own dtypes; any other array dtype name (bfloat16, written by the
# reference through ml_dtypes) decodes as a torch tensor
_NUMPY_NATIVE = frozenset(
    np.dtype(t).name for t in (np.bool_, np.int8, np.uint8, np.int16,
                               np.uint16, np.int32, np.uint32, np.int64,
                               np.uint64, np.float16, np.float32,
                               np.float64, np.complex64, np.complex128))


class SnapshotCorruption(RuntimeError):
    """A snapshot failed structural or checksum validation (torn write,
    truncation, or bit corruption).  Recovery falls back to the previous
    good snapshot (``CheckpointManager.load_latest``)."""


def torch_dtype(name: str) -> torch.dtype:
    """``torch.float32`` from ``"float32"`` or ``"torch.float32"``."""
    got = getattr(torch, name.rsplit(".", 1)[-1], None)
    if not isinstance(got, torch.dtype):
        raise SnapshotCorruption(f"unknown dtype {name!r}")
    return got


def dtype_name(dtype: torch.dtype) -> str:
    """``"float32"`` from ``torch.float32``."""
    return str(dtype).rsplit(".", 1)[-1]


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _tensor_bytes(t: torch.Tensor, synced: set) -> np.ndarray:
    t = t.detach()
    if t.is_cuda and t.device not in synced:
        # work queued on other streams (the service's slots) finishes
        # before the copy below reads the tensor
        torch.cuda.synchronize(t.device)
        synced.add(t.device)
    host = t.contiguous().cpu()               # a blocking copy
    return host.reshape(-1).view(torch.uint8).numpy()


def _enc(obj, arrays: list, blobs: list, synced: set):
    """Recursively encode ``obj`` to a JSON-able node; array data lands in
    ``blobs`` with its geometry in ``arrays``."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, torch.Tensor):
        raw = _tensor_bytes(obj, synced)
        arrays.append({"dtype": str(obj.dtype), "shape": list(obj.shape),
                       "nbytes": int(raw.nbytes), "tensor": True})
        blobs.append(raw)
        return {"_t": "arr", "i": len(arrays) - 1}
    if isinstance(obj, (np.ndarray, np.generic)):
        a = np.asarray(obj)
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
        arrays.append({"dtype": a.dtype.name, "shape": list(a.shape),
                       "nbytes": int(a.nbytes), "tensor": False})
        blobs.append(a.reshape(-1).view(np.uint8))
        return {"_t": "arr", "i": len(arrays) - 1}
    if isinstance(obj, np.dtype):
        return {"_t": "dtype", "name": obj.name}
    if isinstance(obj, torch.dtype):
        return {"_t": "tdtype", "name": dtype_name(obj)}
    if isinstance(obj, StoreStats):
        return {"_t": "StoreStats", "v": _enc(asdict(obj), arrays, blobs,
                                              synced)}
    if isinstance(obj, coding.CodingScheme):
        return {"_t": "CodingScheme",
                "S": obj.num_shards, "C": obj.num_clients,
                "alpha": _enc(np.asarray(obj.alpha), arrays, blobs, synced),
                "omega": _enc(np.asarray(obj.omega), arrays, blobs, synced)}
    if isinstance(obj, coding.StackedRowSpec):
        return {"_t": "StackedRowSpec",
                "clients": [int(c) for c in obj.client_ids],
                "row_len": int(obj.row_len),
                "row_spec": _enc(obj.row_spec, arrays, blobs, synced)}
    if isinstance(obj, StagePlan):
        return {"_t": "StagePlan", "stage": int(obj.stage),
                "shard_clients": _enc(obj.shard_clients, arrays, blobs,
                                      synced)}
    if isinstance(obj, tuple):
        return {"_t": "tuple", "v": [_enc(x, arrays, blobs, synced)
                                     for x in obj]}
    if isinstance(obj, list):
        return {"_t": "list", "v": [_enc(x, arrays, blobs, synced)
                                    for x in obj]}
    if isinstance(obj, (set, frozenset)):
        return {"_t": "set", "v": [_enc(x, arrays, blobs, synced)
                                   for x in sorted(obj, key=repr)]}
    if isinstance(obj, dict):
        return {"_t": "dict", "v": [[_enc(k, arrays, blobs, synced),
                                     _enc(v, arrays, blobs, synced)]
                                    for k, v in obj.items()]}
    raise TypeError(f"snapshot cannot encode {type(obj).__name__}: {obj!r}")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _dec(node, arrays: list):
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    t = node["_t"]
    if t == "arr":
        return arrays[node["i"]]
    if t == "dtype":
        name = node["name"]
        return np.dtype(name) if name in _NUMPY_NATIVE else torch_dtype(name)
    if t == "tdtype":
        return torch_dtype(node["name"])
    if t == "StoreStats":
        return StoreStats(**_dec(node["v"], arrays))
    if t == "CodingScheme":
        return coding.CodingScheme(
            num_shards=node["S"], num_clients=node["C"],
            alpha=np.asarray(_dec(node["alpha"], arrays)),
            omega=np.asarray(_dec(node["omega"], arrays)))
    if t == "StackedRowSpec":
        return coding.StackedRowSpec(tuple(node["clients"]), node["row_len"],
                                     _dec(node["row_spec"], arrays))
    if t == "StagePlan":
        return StagePlan(stage=node["stage"],
                         shard_clients=_dec(node["shard_clients"], arrays))
    if t == "tuple":
        return tuple(_dec(x, arrays) for x in node["v"])
    if t == "list":
        return [_dec(x, arrays) for x in node["v"]]
    if t == "set":
        return set(_dec(x, arrays) for x in node["v"])
    if t == "dict":
        return {_dec(k, arrays): _dec(v, arrays) for k, v in node["v"]}
    raise SnapshotCorruption(f"unknown node tag {t!r}")


def _decode_array(meta: dict, buf: bytearray, base: int, device):
    """One array of the payload: a numpy array for numpy's own dtypes, else
    (a tensor, or the reference's device and bf16 arrays) a torch tensor
    on ``device``."""
    name, shape, n = meta["dtype"], tuple(meta["shape"]), meta["nbytes"]
    off = base + meta["off"]
    as_tensor = (meta.get("tensor", meta.get("jax", False))
                 or name.rsplit(".", 1)[-1] not in _NUMPY_NATIVE)
    if not as_tensor:
        a = np.frombuffer(buf, dtype=np.uint8, count=n, offset=off)
        return a.view(np.dtype(name)).reshape(shape).copy()
    dt = torch_dtype(name)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if n == 0:
        return torch.empty(shape, dtype=dt, device=dev)
    raw = torch.frombuffer(buf, dtype=torch.uint8, count=n, offset=off)
    # a fresh, aligned copy: on the card the upload is it (a blocking copy)
    raw = raw.to(dev) if dev.type != "cpu" else raw.clone()
    return raw.view(dt).reshape(shape)


# ---------------------------------------------------------------------------
# File I/O
# ---------------------------------------------------------------------------

def _fsync_dir(path: str) -> None:
    dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def save_snapshot(path: str, obj) -> int:
    """Serialize ``obj`` to ``path`` with an atomic rename-commit.  Returns
    the committed file size in bytes."""
    arrays: list = []
    blobs: list = []
    root = _enc(obj, arrays, blobs, set())
    off, pcrc = 0, 0
    for meta, blob in zip(arrays, blobs):
        meta["off"] = off
        off += meta["nbytes"]
        pcrc = zlib.crc32(blob, pcrc)
    header = json.dumps({"version": VERSION, "arrays": arrays, "root": root},
                        separators=(",", ":")).encode()
    pre = MAGIC + _FIXED.pack(VERSION, len(header), off, zlib.crc32(header),
                              pcrc)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(pre)
        f.write(header)
        for blob in blobs:
            f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)
    return len(pre) + len(header) + off


def load_snapshot(path: str, device=None):
    """Read, validate (magic, lengths, both checksums), and decode ``path``,
    placing tensors on ``device`` (the CPU when None).  Raises
    ``SnapshotCorruption`` on any validation failure."""
    try:
        with open(path, "rb") as f:
            buf = bytearray(os.fstat(f.fileno()).st_size)
            got = f.readinto(buf)
    except OSError as exc:
        raise SnapshotCorruption(f"unreadable snapshot {path}: {exc}") from exc
    del buf[got:]
    fixed_end = len(MAGIC) + _FIXED.size
    if len(buf) < fixed_end or buf[:len(MAGIC)] != MAGIC:
        raise SnapshotCorruption(f"{path}: bad magic or truncated preamble")
    version, hlen, plen, hcrc, pcrc = _FIXED.unpack_from(buf, len(MAGIC))
    if version != VERSION:
        raise SnapshotCorruption(f"{path}: unsupported version {version}")
    if len(buf) != fixed_end + hlen + plen:
        raise SnapshotCorruption(
            f"{path}: size {len(buf)} != declared {fixed_end + hlen + plen} "
            f"(torn write)")
    view = memoryview(buf)
    header = view[fixed_end: fixed_end + hlen]
    if zlib.crc32(header) != hcrc:
        raise SnapshotCorruption(f"{path}: header checksum mismatch")
    if zlib.crc32(view[fixed_end + hlen:]) != pcrc:
        raise SnapshotCorruption(f"{path}: payload checksum mismatch")
    hd = json.loads(bytes(header))
    del view, header
    arrays = [_decode_array(meta, buf, fixed_end + hlen, device)
              for meta in hd["arrays"]]
    return _dec(hd["root"], arrays)
