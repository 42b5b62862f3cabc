"""The ``TIERS`` registry: hot / warm / cold storage media for coded rounds
(``repro.tiering.tiers`` on torch).

Each tier knows how to *place* a round's payload into its medium, *read* it
back as the ``(C, P)`` slice tensor the decode path expects (on the store's
device), report its *resident bytes*, and *release* its payload.  The tier
ladder is strictly ordered hot → warm → cold (``TIER_ORDER``); demotion
walks down one rung at a time, promotion jumps straight back to hot.

* **hot**  — the exact device tensor (f32/bf16): ``CodedStore``'s behavior;
  reads are free.
* **warm** — host-RAM int8 symmetric per-slice quantization with stored
  scales (``repro_torch.tiering.quant``); reads dequantize on the host and
  upload once.  The first demotion into warm is the lossy event — from then
  on the entry's ``(q, scales)`` payload is canonical and every read
  reconstructs the same bits.
* **cold** — disk-offloaded ``[C·P int8 | C f32 scales]`` file, written once
  with the durability layer's atomic idiom (tmp + fsync + ``os.replace`` +
  dir fsync) and read back through ``np.memmap``; the file doubles as the
  snapshot's cold pointer, so resume never re-writes or re-quantizes.

A ``TierEntry`` is the per-round record the tiers operate on; it lives in
the ``TieredStore``'s tier table and carries the payload slots for every
medium plus the access stats the eviction policies consume.
"""
from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tiering.quant import dequantize_int8, quantize_int8


@dataclass
class TierEntry:
    """One stored round's tier state: payload slots + access accounting."""
    key: int                                  # round id
    shape: Tuple[int, int]                    # (C, P)
    dtype: torch.dtype                        # hot-tier dtype
    tier: str = "hot"                         # current residence
    device: Optional[torch.Tensor] = None     # hot payload
    q: Optional[np.ndarray] = None            # warm payload (int8)
    scales: Optional[np.ndarray] = None       # canonical once lossy (f32 (C,))
    path: Optional[str] = None                # cold payload (file)
    file_crc: Optional[int] = None            # crc32 of the cold file bytes
    lossy: bool = False                       # passed through int8 at least once
    hits: int = 0
    last_access: int = 0
    stage: int = 0                            # birth order (stage-age eviction)
    home: Optional[torch.device] = None       # where hot tensors live

    def hot_nbytes(self) -> int:
        c, p = self.shape
        return c * p * torch.empty((), dtype=self.dtype).element_size()

    def warm_nbytes(self) -> int:
        c, p = self.shape
        return c * p + c * 4                   # int8 payload + f32 scales

    def nbytes(self) -> int:
        """Bytes resident in the entry's *current* tier's medium."""
        return {"hot": self.hot_nbytes, "warm": self.warm_nbytes,
                "cold": self.warm_nbytes}[self.tier]()


TIERS: Dict[str, "Tier"] = {}
TIER_ORDER = ("hot", "warm", "cold")


def register_tier(name: str):
    def deco(cls):
        cls.name = name
        TIERS[name] = cls()
        return cls
    return deco


def next_tier(name: str) -> Optional[str]:
    i = TIER_ORDER.index(name)
    return TIER_ORDER[i + 1] if i + 1 < len(TIER_ORDER) else None


class Tier:
    """One rung of the ladder.  ``place`` moves an entry's payload into this
    medium (from the rung directly above, or from an exact tensor on first
    admit); ``read`` returns the slice tensor on the entry's ``home``
    device; ``release`` drops this medium's payload."""

    name: str = ""

    def place(self, entry: TierEntry, **ctx) -> None:
        raise NotImplementedError

    def read(self, entry: TierEntry) -> torch.Tensor:
        raise NotImplementedError

    def release(self, entry: TierEntry) -> None:
        raise NotImplementedError


@register_tier("hot")
class HotTier(Tier):
    def place(self, entry: TierEntry, array=None, **ctx) -> None:
        if array is not None:                    # fresh admit (put path)
            entry.device = array
        else:                                    # promotion: decode from below
            entry.device = TIERS[entry.tier].read(entry)
        entry.tier = "hot"

    def read(self, entry: TierEntry) -> torch.Tensor:
        return entry.device

    def release(self, entry: TierEntry) -> None:
        entry.device = None


@register_tier("warm")
class WarmTier(Tier):
    def place(self, entry: TierEntry, **ctx) -> None:
        if entry.q is None:
            if entry.path is not None:
                # the cold file is canonical: reload rather than requantize
                entry.q, entry.scales = _read_cold_file(entry)
            else:
                # passing stored scales keeps requantization bit-exact for
                # already-lossy entries (see quant module docstring)
                entry.q, entry.scales = quantize_int8(entry.device,
                                                      scales=entry.scales)
        entry.lossy = True
        TIERS["hot"].release(entry)
        entry.tier = "warm"

    def read(self, entry: TierEntry) -> torch.Tensor:
        return dequantize_int8(entry.q, entry.scales, dtype=entry.dtype,
                               device=entry.home)

    def release(self, entry: TierEntry) -> None:
        entry.q = None                 # scales stay: canonical once lossy


@register_tier("cold")
class ColdTier(Tier):
    def place(self, entry: TierEntry, cold_dir: str = None, **ctx) -> None:
        if entry.path is None:
            if cold_dir is None:
                raise ValueError("cold tier needs an offload directory")
            entry.path = os.path.join(cold_dir, f"round{entry.key}.tier")
            entry.file_crc = _write_cold_file(entry.path, entry.q,
                                              entry.scales)
        TIERS["warm"].release(entry)
        entry.tier = "cold"

    def read(self, entry: TierEntry) -> torch.Tensor:
        q, scales = _read_cold_file(entry)
        return dequantize_int8(q, scales, dtype=entry.dtype,
                               device=entry.home)

    def release(self, entry: TierEntry) -> None:
        pass                           # the file outlives residence: it is
                                       # the canonical lossy payload


# ---------------------------------------------------------------------------
# Cold-file I/O — [C*P int8 | C f32 scales], atomic-rename committed
# ---------------------------------------------------------------------------

def _write_cold_file(path: str, q: np.ndarray, scales: np.ndarray) -> int:
    """Commit ``[q | scales]`` with the durability layer's atomic idiom so a
    crash mid-offload can only leave a tmp file, never a torn cold round.
    Returns the crc32 of the committed bytes (the snapshot manifest's
    integrity pointer)."""
    head = np.ascontiguousarray(q, dtype=np.int8)
    tail = np.ascontiguousarray(scales, dtype=np.float32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(head)
        f.write(tail)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return zlib.crc32(tail, zlib.crc32(head))


def _read_cold_file(entry: TierEntry) -> Tuple[np.ndarray, np.ndarray]:
    """mmap-backed read: the int8 payload maps lazily (the dequant multiply
    is the only full materialization); scales read from the tail."""
    c, p = entry.shape
    q = np.memmap(entry.path, dtype=np.int8, mode="r", shape=(c, p))
    with open(entry.path, "rb") as f:
        f.seek(c * p)
        scales = np.frombuffer(f.read(c * 4), dtype=np.float32)
    if scales.shape != (c,):
        raise IOError(f"cold file {entry.path} truncated: "
                      f"expected {c} scales, got {scales.shape}")
    return q, scales


def cold_file_crc(path: str) -> int:
    with open(path, "rb") as f:
        return zlib.crc32(f.read())
