"""Coded computing-based sharding (paper Sec 3.3), on torch tensors.

The per-round, per-shard intermediate parameters (one vector per shard,
stacked to ``W in R^{S x P}``) are Lagrange-encoded (eq. 5/6) at client
points ``alpha_i`` — a (C, S) @ (S, P) product, i.e. a Reed-Solomon code of
dimension S and length C — and reconstructed from any S intact slices by
re-interpolation (eq. 7), or around up to floor((C-S)/2) corrupted slices
located by Berlekamp-Welch or consensus decoding (eq. 11).

The coefficient matrices and the error localization stay float64 numpy on
the host, copied from ``repro.core.coding`` with the same arithmetic, so
they match the reference bit for bit.  The products over P run through the
``coded_matmul`` / ``coded_matmul_rounds`` / ``coded_encode_decode``
wrappers: the CUDA kernels for tensors on the card, their plain versions
for tensors on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.tree import (empty_paths, leaves_with_paths,
                                   tree_unflatten)
from repro_torch.kernels.coded_matmul.ops import (coded_encode_decode,
                                                  coded_matmul,
                                                  coded_matmul_rounds)

DTypeLike = Union[None, str, torch.dtype]


class CodingBudgetExceeded(RuntimeError):
    """Corruption (or erasure) beyond the correctable budget of eq. 11."""

    def __init__(self, observed: int, max_errors: int,
                 kind: str = "corrupted slices"):
        self.observed = int(observed)
        self.max_errors = int(max_errors)
        self.kind = kind
        super().__init__(
            f"{kind} count {self.observed} exceeds the correctable budget "
            f"max_errors={self.max_errors} (2*mu*C <= C - S, eq. 11)")


def as_dtype(dtype: DTypeLike) -> Optional[torch.dtype]:
    """A slice storage dtype from a torch dtype or its name ('bfloat16')."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "__name__", None) or str(dtype)
    got = getattr(torch, name.rsplit(".", 1)[-1], None)
    if not isinstance(got, torch.dtype):
        raise ValueError(f"slice_dtype {dtype!r} is not a dtype; use e.g. "
                         f"'bfloat16' or 'float32'")
    return got


def chebyshev_points(n: int, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """Chebyshev nodes — well-conditioned interpolation points."""
    k = np.arange(n)
    x = np.cos((2 * k + 1) / (2 * n) * np.pi)
    return (lo + hi) / 2 + (hi - lo) / 2 * x


def lagrange_coeff_matrix(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """M[j, i] = l_i^{(src)}(dst_j): evaluate the Lagrange basis over ``src``
    points at ``dst`` points. Encode: src=omega, dst=alpha. Decode: src=alpha
    subset, dst=omega."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = len(src)
    m = np.ones((len(dst), n), np.float64)
    for i in range(n):
        for j in range(n):
            if j != i:
                m[:, i] *= (dst - src[j]) / (src[i] - src[j])
    return m


@dataclass(frozen=True)
class CodingScheme:
    """Evaluation-point layout for one (C clients, S shards) code."""
    num_shards: int                  # S — code dimension
    num_clients: int                 # C — code length
    alpha: np.ndarray = field(default=None)   # (C,) client points
    omega: np.ndarray = field(default=None)   # (S,) shard points

    def __post_init__(self):
        if self.num_clients < self.num_shards:
            raise ValueError("need C >= S")
        if self.alpha is None:
            object.__setattr__(self, "alpha",
                               chebyshev_points(self.num_clients, -1.0, 1.0))
        if self.omega is None:
            # interleave shard points strictly inside the alpha hull
            object.__setattr__(self, "omega",
                               chebyshev_points(self.num_shards, -0.95, 0.95))

    def encode_matrix(self) -> np.ndarray:
        """(C, S): B[i, s] = l_s(alpha_i). eq. (6)."""
        return lagrange_coeff_matrix(self.omega, self.alpha)

    def decode_matrix(self, client_ids: Sequence[int]):
        """(S, S) re-interpolation from a slice subset back to omega, and the
        ids it reads: with more than S slices, a well-spread subset (greedy
        farthest-point on the alpha line)."""
        ids = np.asarray(client_ids)
        if len(ids) < self.num_shards:
            raise ValueError("need at least S slices")
        if len(ids) > self.num_shards:
            pts = self.alpha[ids]
            chosen = [int(np.argmin(pts)), int(np.argmax(pts))]
            while len(chosen) < self.num_shards:
                dmin = np.min(np.abs(pts[:, None] - pts[chosen][None, :]), axis=1)
                dmin[chosen] = -1
                chosen.append(int(np.argmax(dmin)))
            ids = ids[np.sort(chosen)]
        return lagrange_coeff_matrix(self.alpha[ids], self.omega), ids

    def quorum(self, available: Optional[Sequence[int]] = None) -> np.ndarray:
        """The canonical S-slice read set ``decode_matrix`` selects from
        ``available`` (default: all C)."""
        ids = list(available) if available is not None \
            else list(range(self.num_clients))
        _, chosen = self.decode_matrix(ids)
        return np.asarray([int(i) for i in chosen])

    def reduced(self, available: Sequence[int]) -> "CodingScheme":
        """The code restricted to ``available`` slice rows (same dimension,
        budget ``(len(available) - S) // 2``)."""
        avail = np.asarray(sorted(int(i) for i in available))
        return CodingScheme(self.num_shards, len(avail),
                            alpha=np.asarray(self.alpha)[avail],
                            omega=self.omega)

    @property
    def max_errors(self) -> int:
        """mu*C with 2*mu*C <= C - S (eq. 11)."""
        return (self.num_clients - self.num_shards) // 2


def _matrix(mat: np.ndarray, device) -> torch.Tensor:
    """A float64 host coefficient matrix as a float32 device tensor."""
    return torch.tensor(np.asarray(mat, np.float64), dtype=torch.float32,
                        device=device)


# ---------------------------------------------------------------------------
# Encode / decode on (stacked) parameter matrices
# ---------------------------------------------------------------------------

def encode(scheme: CodingScheme, shard_params: torch.Tensor,
           out_dtype: DTypeLike = None) -> torch.Tensor:
    """shard_params: (S, P) -> coded slices (C, P). eq. (6).  ``out_dtype``
    optionally stores the slices in e.g. bf16; accumulation is fp32."""
    b = _matrix(scheme.encode_matrix(), shard_params.device)
    return coded_matmul(b, shard_params.float().contiguous(),
                        out_dtype=as_dtype(out_dtype))


def encode_batched(scheme: CodingScheme, mats: Sequence[torch.Tensor],
                   out_dtype: DTypeLike = None) -> list:
    """Encode G (S, P_g) matrices in ONE product: the rounds are concatenated
    to (S, sum_g P_g) and streamed through one ``coded_matmul``.  Returns
    per-round (C, P_g) views of the result."""
    widths = [int(m.shape[1]) for m in mats]
    w = mats[0] if len(mats) == 1 else torch.cat(list(mats), dim=1)
    coded = encode(scheme, w, out_dtype=out_dtype)
    outs, off = [], 0
    for p in widths:
        outs.append(coded[:, off:off + p])
        off += p
    return outs


def encode_rounds(enc: torch.Tensor, hist: torch.Tensor,
                  out_dtype: DTypeLike = None) -> torch.Tensor:
    """All-rounds Lagrange encode: ``hist (G, S, P) -> (G, C, P)`` in one
    ``coded_matmul_rounds`` launch, read straight from the stacked history.
    ``enc`` is the (C, S) encode matrix as a float32 tensor."""
    return coded_matmul_rounds(enc.float().contiguous(),
                               hist.float().contiguous(),
                               out_dtype=as_dtype(out_dtype))


def decode_erasure(scheme: CodingScheme, slices: torch.Tensor,
                   client_ids: Sequence[int]) -> torch.Tensor:
    """Reconstruct (S, P) from >= S intact slices (rows of ``slices``).

    slices: (len(client_ids), P) — coded slices from those clients.
    """
    d, ids = scheme.decode_matrix(client_ids)
    dm = _matrix(d, slices.device)
    order = [int(c) for c in client_ids]
    rows = torch.tensor([order.index(int(i)) for i in ids],
                        device=slices.device)
    sl = slices.index_select(0, rows).float().contiguous()
    return coded_matmul(dm, sl)


def encode_decode_operators(scheme: CodingScheme,
                            client_ids: Optional[Sequence[int]] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """The float64 (C, S) encode and (S, C) decode matrices of the round
    trip from ``client_ids`` (default: all C); the decode matrix has zero
    columns for the unused clients."""
    ids = list(client_ids) if client_ids is not None else \
        list(range(scheme.num_clients))
    d, used = scheme.decode_matrix(ids)
    dec = np.zeros((scheme.num_shards, scheme.num_clients), np.float64)
    dec[:, [int(i) for i in used]] = d
    return scheme.encode_matrix(), dec


def encode_decode(scheme: CodingScheme, shard_params: torch.Tensor,
                  client_ids: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The code round trip: encode (S, P) to C slices and decode it again
    from ``client_ids`` (default: all C), the slice-verification path.  One
    ``coded_encode_decode`` launch streams ``dec @ (enc @ w)`` per column
    tile, so the (C, P) coded intermediate never reaches device memory."""
    enc, dec = encode_decode_operators(scheme, client_ids)
    dev = shard_params.device
    return coded_encode_decode(_matrix(enc, dev), _matrix(dec, dev),
                               shard_params.float().contiguous())


# ---------------------------------------------------------------------------
# Berlekamp-Welch error localization (float64, control-plane)
# ---------------------------------------------------------------------------

def _consistency_residual(scheme: CodingScheme, slices: np.ndarray,
                          trusted: np.ndarray) -> np.ndarray:
    """Decode from ``trusted[:S]`` rows, re-encode, return per-row residual."""
    d, ids = scheme.decode_matrix(list(trusted))
    rows = [list(trusted).index(int(i)) for i in ids]
    w = d @ slices[trusted[rows]]
    b = scheme.encode_matrix()
    recon = b @ w
    denom = np.abs(slices).mean() + 1e-12
    return np.abs(recon - slices).mean(axis=1) / denom


def locate_errors(scheme: CodingScheme, slices: np.ndarray,
                  num_probe: int = 8, seed: int = 0, tol: float = 1e-3,
                  method: str = "bw") -> np.ndarray:
    """Identify corrupted slice rows. slices: (C, P) float array.

    method="bw": Berlekamp-Welch by float64 least squares on ``num_probe``
    coordinates with a majority vote, verified by a consistency check and
    falling back to consensus decoding; method="ransac": consensus decoding
    over sampled S-subsets.  Raises ``CodingBudgetExceeded`` beyond eq. 11.
    """
    slices = np.asarray(slices, np.float64)
    c, p = slices.shape
    s = scheme.num_shards
    e = scheme.max_errors
    # fast path: no errors at all
    resid0 = _consistency_residual(scheme, slices, np.arange(c))
    if resid0.max() < tol:
        return np.array([], np.int64)
    if e == 0:
        raise CodingBudgetExceeded(int((resid0 >= tol).sum()), 0)
    a = np.asarray(scheme.alpha, np.float64)
    rng = np.random.default_rng(seed)

    if method == "ransac":
        best_bad, best_inliers = None, -1
        for _ in range(128):
            pick = rng.choice(c, size=s, replace=False)
            r = _consistency_residual(scheme, slices, pick)
            inliers = int((r < tol).sum())
            if inliers > best_inliers:
                best_inliers = inliers
                best_bad = np.where(r >= tol)[0]
            if inliers >= c - e:
                break
        bad = np.sort(best_bad)
        if len(bad) > e:
            raise CodingBudgetExceeded(len(bad), e)
        return bad

    cols = rng.choice(p, size=min(num_probe, p), replace=False)
    votes = np.zeros(c)
    va_q = np.vander(a, s + e, increasing=True)          # Q: deg < S+e
    va_e = np.vander(a, e, increasing=True)              # E: monic deg e
    for col in cols:
        y = slices[:, col]
        # Q(a_i) - y_i*(E_0 + ... + E_{e-1} a^{e-1}) = y_i * a^e
        lhs = np.concatenate([va_q, -y[:, None] * va_e], axis=1)
        rhs = y * a ** e
        sol, *_ = np.linalg.lstsq(lhs, rhs, rcond=None)
        e_coeffs = np.concatenate([sol[s + e:], [1.0]])  # monic
        e_vals = np.abs(np.polyval(e_coeffs[::-1], a))
        votes += e_vals < 0.05 * np.median(e_vals + 1e-300)
    bad = np.sort(np.where(votes > len(cols) / 2)[0])
    # verify: decoding without the located rows must be self-consistent on
    # EVERY surviving row
    good = np.setdiff1d(np.arange(c), bad)
    if len(good) >= s and len(bad) <= e:
        r = _consistency_residual(scheme, slices, good)
        if r[good].max() < tol:
            return bad
    # fall back to consensus decoding
    return locate_errors(scheme, slices, num_probe, seed, tol, method="ransac")


def decode_robust(scheme: CodingScheme, slices: torch.Tensor,
                  available: Optional[Sequence[int]] = None,
                  tol: float = 1e-3, seed: int = 0
                  ) -> Tuple[torch.Tensor, list, list]:
    """Quorum read: reconstruct (S, P) despite erased AND corrupted slices.

    ``slices``: the full (C, P) coded tensor (unavailable rows are never
    used).  ``available``: the present row ids (None = all C).  A consistency
    pre-check over the surviving rows; if clean, a plain erasure decode,
    otherwise error localization on the code restricted to the surviving
    rows, then an erasure decode without the located rows.

    Returns ``(w, lost_ids, bad_ids)``.
    """
    c = scheme.num_clients
    avail = sorted(int(i) for i in (available if available is not None
                                    else range(c)))
    lost = sorted(set(range(c)) - set(avail))
    if len(avail) < scheme.num_shards:
        raise CodingBudgetExceeded(len(lost), c - scheme.num_shards,
                                   kind="erased slices")
    sub = slices.detach().to("cpu", torch.float64).numpy()[avail]
    red = scheme if not lost else scheme.reduced(avail)
    resid = _consistency_residual(red, sub, np.arange(len(avail)))
    if resid.max() < tol:
        rows = torch.tensor(avail, device=slices.device)
        return decode_erasure(scheme, slices.index_select(0, rows),
                              avail), lost, []
    bad_local = locate_errors(red, sub, tol=tol, seed=seed)
    bad = sorted(avail[int(i)] for i in bad_local)
    good = [i for i in avail if i not in set(bad)]
    if len(good) < scheme.num_shards:
        raise CodingBudgetExceeded(len(bad), red.max_errors)
    rows = torch.tensor(good, device=slices.device)
    return decode_erasure(scheme, slices.index_select(0, rows),
                          good), lost, bad


# ---------------------------------------------------------------------------
# Parameter tree <-> flat parameter matrix (sorted-key leaf order)
# ---------------------------------------------------------------------------

def tree_to_flat(tree) -> Tuple[torch.Tensor, object]:
    """Flatten a parameter tree to a 1-D f32 vector + re-assembly spec."""
    items = list(leaves_with_paths(tree))
    flat = torch.cat([leaf.reshape(-1).float() for _, leaf in items])
    spec = ([p for p, _ in items],
            [(tuple(leaf.shape), leaf.dtype) for _, leaf in items],
            empty_paths(tree))
    return flat, spec


def flat_to_tree(flat: torch.Tensor, spec) -> object:
    paths, shapes, empties = spec
    leaves, off = [], 0
    for shape, dtype in shapes:
        n = int(np.prod(shape)) if shape else 1
        leaves.append(flat[off: off + n].reshape(shape).to(dtype))
        off += n
    return tree_unflatten(paths, leaves, empties)


def tree_to_flat_stacked(tree) -> Tuple[torch.Tensor, object]:
    """Flatten a stacked ``(M, ...)`` tree to an ``(M, P)`` f32 matrix in one
    concatenate.  Row ``i`` equals ``tree_to_flat`` of client ``i``'s tree,
    and the returned spec is the per-row spec."""
    items = list(leaves_with_paths(tree))
    m = items[0][1].shape[0]
    flat = torch.cat([leaf.reshape(m, -1).float() for _, leaf in items],
                     dim=1)
    spec = ([p for p, _ in items],
            [(tuple(leaf.shape[1:]), leaf.dtype) for _, leaf in items],
            empty_paths(tree))
    return flat, spec


def flat_to_stacked_tree(flat: torch.Tensor, spec) -> object:
    """Inverse of ``tree_to_flat_stacked``: (M, P) -> stacked (M, ...) tree."""
    paths, shapes, empties = spec
    m = flat.shape[0]
    leaves, off = [], 0
    for shape, dtype in shapes:
        n = int(np.prod(shape)) if shape else 1
        leaves.append(flat[:, off: off + n].reshape((m, *shape)).to(dtype))
        off += n
    return tree_unflatten(paths, leaves, empties)


@dataclass(frozen=True)
class StackedRowSpec:
    """Re-assembly spec for a shard vector laid out as M client rows: the
    client-major concat of ``row_len``-sized rows, one per client in
    ``client_ids`` order; ``row_spec`` is the per-client spec."""
    client_ids: Tuple[int, ...]
    row_len: int
    row_spec: object


def flat_to_client_trees(flat: torch.Tensor, spec: StackedRowSpec) -> dict:
    """Reassemble a decoded shard vector into {client_id: param tree}."""
    rows = flat[: len(spec.client_ids) * spec.row_len].reshape(
        len(spec.client_ids), spec.row_len)
    return {c: flat_to_tree(rows[i], spec.row_spec)
            for i, c in enumerate(spec.client_ids)}
