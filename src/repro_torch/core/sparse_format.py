"""Compressed weight formats and static iteration schedules (paper §III-C/D).

A copy of the numpy artifact builders of the reference
(``repro/core/sparse_format.py``); every array they produce is equal to
the reference's.  Conv kernels are stored in merged-row-index COO:

    W.RI = oc * IC + ic        (row index over the flattened (OC, IC) grid)
    W.CI = kernel column       (position within the 1-D kernel window)

sorted in output-channel order.  ``build_schedule`` precomputes the
Algorithm-2 iteration schedule (compute / extra / empty slots), whose
static counts the fused kernel reports and the ``stream`` backend
executes; ``block_sparse_from_dense`` re-blocks the kernel into the static
block-sparse tiles the ``cuda`` conv kernel walks.  FC layers carry a
1-bit weight mask (:class:`WeightMask`); the bit-width helpers give the
storage costs of paper Table II.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "CooKernel",
    "coo_from_dense",
    "coo_to_dense",
    "coo_bit_widths",
    "coo_storage_bits",
    "dense_storage_bits",
    "break_even_density",
    "Schedule",
    "build_schedule",
    "WeightMask",
    "weight_mask_from_dense",
    "BlockSparseKernel",
    "block_sparse_from_dense",
    "block_sparse_to_dense",
]

# Iteration kinds in the static schedule (paper Algorithm 2).
ITER_COMPUTE = 0  # a real non-zero weight accumulation
ITER_EXTRA = 1    # output channel with no nnz: load/decay/emit/store only
ITER_EMPTY = 2    # stall slot: wait for an input channel to stream in


@dataclasses.dataclass(frozen=True)
class CooKernel:
    """Merged-row-index COO conv kernel, entries sorted by (oc, ic, ci)."""

    data: np.ndarray      # (nnz,) weight values
    row_idx: np.ndarray   # (nnz,) int32, RI = oc * IC + ic
    col_idx: np.ndarray   # (nnz,) int32, CI = kernel column in [0, KW)
    kw: int
    ic: int
    oc: int

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def density(self) -> float:
        total = self.kw * self.ic * self.oc
        return self.nnz / total if total else 0.0

    def oc_of(self, i: int) -> int:
        return int(self.row_idx[i]) // self.ic  # eq. (2)

    def ic_of(self, i: int) -> int:
        return int(self.row_idx[i]) % self.ic   # eq. (1)


def coo_from_dense(kernel: np.ndarray) -> CooKernel:
    """kernel: (KW, IC, OC) dense -> COO sorted by (oc, ic, ci)."""
    if kernel.ndim != 3:
        raise ValueError(f"expected (KW, IC, OC) kernel, got {kernel.shape}")
    kw, ic, oc = kernel.shape
    ci_g, ic_g, oc_g = np.nonzero(kernel)
    order = np.lexsort((ci_g, ic_g, oc_g))
    ci_g, ic_g, oc_g = ci_g[order], ic_g[order], oc_g[order]
    data = kernel[ci_g, ic_g, oc_g]
    row = (oc_g * ic + ic_g).astype(np.int32)
    return CooKernel(data=np.asarray(data), row_idx=row,
                     col_idx=ci_g.astype(np.int32), kw=kw, ic=ic, oc=oc)


def coo_to_dense(coo: CooKernel) -> np.ndarray:
    out = np.zeros((coo.kw, coo.ic, coo.oc), dtype=coo.data.dtype)
    oc = coo.row_idx // coo.ic
    ic = coo.row_idx % coo.ic
    out[coo.col_idx, ic, oc] = coo.data
    return out


def coo_bit_widths(kw: int, ic: int, oc: int, data_bits: int = 16) -> Tuple[int, int, int]:
    """(W.D, W.RI, W.CI) bit widths as in paper Table II."""
    ri_bits = max(1, int(np.ceil(np.log2(ic * oc))))
    ci_bits = max(1, int(np.ceil(np.log2(kw))))
    return data_bits, ri_bits, ci_bits


def dense_storage_bits(kw: int, ic: int, oc: int, data_bits: int = 16) -> int:
    return kw * ic * oc * data_bits


def coo_storage_bits(kw: int, ic: int, oc: int, density: float,
                     data_bits: int = 16) -> float:
    d, ri, ci = coo_bit_widths(kw, ic, oc, data_bits)
    return (d + ri + ci) * kw * ic * oc * density


def break_even_density(kw: int, ic: int, oc: int, data_bits: int = 16) -> float:
    """Density below which COO is more bit-efficient than dense (Table II)."""
    d, ri, ci = coo_bit_widths(kw, ic, oc, data_bits)
    return data_bits / (d + ri + ci)


# ---------------------------------------------------------------------------
# Static schedule (Algorithm 2): NNZ + extra + empty iterations precomputed.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schedule:
    """Fixed-length iteration schedule for one conv layer (see reference)."""

    kind: np.ndarray     # (reps,) int32 in {COMPUTE, EXTRA, EMPTY}
    weight: np.ndarray   # (reps,) float32; 0 for non-compute entries
    oc: np.ndarray       # (reps,) int32; channel acted upon (-1 for empty)
    ic: np.ndarray       # (reps,) int32; input channel (-1 if n/a)
    ci: np.ndarray       # (reps,) int32; kernel column (0 if n/a)
    emit: np.ndarray     # (reps,) bool; True -> fire/emit/store this oc now
    n_compute: int
    n_extra: int
    n_empty: int

    @property
    def reps(self) -> int:
        return int(self.kind.shape[0])


def build_schedule(coo: CooKernel) -> Schedule:
    """Precompute the Algorithm-2 iteration schedule for a COO kernel.

    Every slot ingests at most one input channel in streaming order; a
    compute slot for a weight on input channel ``ic`` runs only once that
    channel has arrived, otherwise the slot is an empty (stall) iteration;
    an output channel with no non-zero weight gets one extra iteration.
    """
    kinds, weights, ocs, ics, cis, emits = [], [], [], [], [], []

    oc_of = coo.row_idx // coo.ic
    ic_of = coo.row_idx % coo.ic

    ic_read = 0   # input channels streamed in so far
    ptr = 0       # index into nnz list

    def ingest():
        nonlocal ic_read
        ic_read = min(ic_read + 1, coo.ic)

    for oc in range(coo.oc):
        start = ptr
        while ptr < coo.nnz and int(oc_of[ptr]) == oc:
            ptr += 1
        end = ptr
        if start == end:
            kinds.append(ITER_EXTRA)
            weights.append(0.0)
            ocs.append(oc)
            ics.append(-1)
            cis.append(0)
            emits.append(True)
            ingest()
            continue
        for j in range(start, end):
            need_ic = int(ic_of[j])
            while need_ic >= min(ic_read + 1, coo.ic):
                kinds.append(ITER_EMPTY)
                weights.append(0.0)
                ocs.append(-1)
                ics.append(min(ic_read, coo.ic - 1))
                cis.append(0)
                emits.append(False)
                ingest()
            kinds.append(ITER_COMPUTE)
            weights.append(float(coo.data[j]))
            ocs.append(oc)
            ics.append(need_ic)
            cis.append(int(coo.col_idx[j]))
            emits.append(j == end - 1)
            ingest()

    kind = np.asarray(kinds, dtype=np.int32)
    return Schedule(
        kind=kind,
        weight=np.asarray(weights, dtype=np.float32),
        oc=np.asarray(ocs, dtype=np.int32),
        ic=np.asarray(ics, dtype=np.int32),
        ci=np.asarray(cis, dtype=np.int32),
        emit=np.asarray(emits, dtype=bool),
        n_compute=int((kind == ITER_COMPUTE).sum()),
        n_extra=int((kind == ITER_EXTRA).sum()),
        n_empty=int((kind == ITER_EMPTY).sum()),
    )


# ---------------------------------------------------------------------------
# Weight mask (paper §III-B, Fig. 2) — FC layers.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WeightMask:
    """1-bit-per-weight mask for an FC weight matrix (IN, OUT)."""

    weights: np.ndarray  # (IN, OUT) with zeros at masked positions
    mask: np.ndarray     # (IN, OUT) bool, True where weight != 0

    @property
    def density(self) -> float:
        return float(self.mask.mean())

    def fetch_mask(self, spikes: np.ndarray) -> np.ndarray:
        """FM = IFM AND WM: which weights must actually be fetched."""
        s = np.asarray(spikes).astype(bool)
        return s[..., :, None] & self.mask  # (..., IN, OUT)


def weight_mask_from_dense(weights: np.ndarray) -> WeightMask:
    w = np.asarray(weights)
    mask = w != 0
    return WeightMask(weights=w * mask, mask=mask)


# ---------------------------------------------------------------------------
# Static block-sparse layout (the tiles the ``cuda`` conv kernel walks).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockSparseKernel:
    """W'(OC, K=IC*KW) tiled into (block_oc, block_k) tiles.

    Per oc-tile row only non-empty tiles are kept, and the list is padded
    to the longest row with zero tiles pointing at k-tile 0 (no-ops).
    """

    blocks: np.ndarray       # (n_oc_tiles, max_tiles, block_oc, block_k)
    block_cols: np.ndarray   # (n_oc_tiles, max_tiles) int32 k-tile index
    tile_valid: np.ndarray   # (n_oc_tiles, max_tiles) bool
    n_tiles_per_row: np.ndarray  # (n_oc_tiles,) int32
    oc: int
    k: int                   # IC * KW (flattened reduction dim)
    kw: int
    ic: int
    block_oc: int
    block_k: int

    @property
    def n_oc_tiles(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def max_tiles(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def padded_oc(self) -> int:
        return self.n_oc_tiles * self.block_oc

    @property
    def padded_k(self) -> int:
        return int(-(-self.k // self.block_k)) * self.block_k

    @property
    def tile_density(self) -> float:
        total = self.n_oc_tiles * (self.padded_k // self.block_k)
        return float(self.n_tiles_per_row.sum()) / total if total else 0.0


def _flatten_kernel(kernel: np.ndarray) -> np.ndarray:
    """(KW, IC, OC) -> W'(OC, IC*KW) with K index = ic * KW + ci."""
    kw, ic, oc = kernel.shape
    return np.transpose(kernel, (2, 1, 0)).reshape(oc, ic * kw)


def block_sparse_from_dense(
    kernel: np.ndarray, block_oc: int = 8, block_k: int = 128
) -> BlockSparseKernel:
    kw, ic, oc = kernel.shape
    w = _flatten_kernel(kernel)
    k = ic * kw
    w = np.pad(w, ((0, (-oc) % block_oc), (0, (-k) % block_k)))
    n_oc_tiles = w.shape[0] // block_oc
    n_k_tiles = w.shape[1] // block_k

    tiles = w.reshape(n_oc_tiles, block_oc, n_k_tiles,
                      block_k).transpose(0, 2, 1, 3)
    nonempty = np.abs(tiles).sum(axis=(2, 3)) != 0  # (n_oc_tiles, n_k_tiles)
    counts = nonempty.sum(axis=1).astype(np.int32)
    max_tiles = max(1, int(counts.max()) if counts.size else 1)

    blocks = np.zeros((n_oc_tiles, max_tiles, block_oc, block_k),
                      dtype=kernel.dtype)
    block_cols = np.zeros((n_oc_tiles, max_tiles), dtype=np.int32)
    tile_valid = np.zeros((n_oc_tiles, max_tiles), dtype=bool)
    for r in range(n_oc_tiles):
        for j, c in enumerate(np.nonzero(nonempty[r])[0]):
            blocks[r, j] = tiles[r, c]
            block_cols[r, j] = c
            tile_valid[r, j] = True
    return BlockSparseKernel(
        blocks=blocks, block_cols=block_cols, tile_valid=tile_valid,
        n_tiles_per_row=counts, oc=oc, k=k, kw=kw, ic=ic,
        block_oc=block_oc, block_k=block_k)


def block_sparse_to_dense(bs: BlockSparseKernel) -> np.ndarray:
    """Inverse of ``block_sparse_from_dense`` -> (KW, IC, OC)."""
    n_k_tiles = bs.padded_k // bs.block_k
    w = np.zeros((bs.n_oc_tiles, n_k_tiles, bs.block_oc, bs.block_k),
                 dtype=bs.blocks.dtype)
    for r in range(bs.n_oc_tiles):
        for j in range(bs.max_tiles):
            if bs.tile_valid[r, j]:
                w[r, bs.block_cols[r, j]] = bs.blocks[r, j]
    w = w.transpose(0, 2, 1, 3).reshape(bs.n_oc_tiles * bs.block_oc,
                                        n_k_tiles * bs.block_k)
    w = w[: bs.oc, : bs.k]  # strip padding
    # (OC, IC*KW) -> (KW, IC, OC)
    return w.reshape(bs.oc, bs.ic, bs.kw).transpose(2, 1, 0)
