"""Gated one-to-all product (GOAP) convolution (paper §III-C).

Port of ``repro/core/goap.py``.  The input feature map is pre-padded,
I: (..., IC, WI) binary; the kernel is (KW, IC, OC); the valid 1-D
convolution gives O: (..., OC, OI) with OI = WI - KW + 1.  Leading batch
dimensions are carried through (the reference vmaps instead).

``build_shift_buffer`` gives X'(IC*KW, OI) with X'[ic*KW + ci, oi] =
I[ic, oi + ci] (rows **ic-major**); the dense conv is ``W'(OC, IC*KW) @ X'``.

Implementations, all equal to the dense oracle:

* ``conv1d_dense_oracle`` — im2col matmul in the kernel's dtype (a bf16
  kernel gives bf16 currents, the product taken in f32 and rounded once,
  as XLA computes a bf16 dot: :func:`matmul_rounded`);
* ``goap_conv_packed`` — the serving hot path (f32, as in the reference);
* ``goap_conv_nnz`` — every non-zero weight adds ``w * EM`` to its
  output row (gather + scatter-add, f32);
* ``goap_conv_reference`` / ``goap_conv_reference_loop`` — Algorithm 1 in
  numpy float64 (tests), the vectorized one bit-identical to the loop.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Union

import numpy as np
import torch

from .sparse_format import CooKernel

__all__ = ["matmul_rounded", "build_shift_buffer", "conv1d_dense_oracle",
           "PackedCoo", "goap_pack", "goap_conv_packed", "goap_conv_nnz",
           "goap_conv_reference", "goap_conv_reference_loop"]


def matmul_rounded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as XLA computes a product of one 16-bit float dtype: in
    f32, rounded once to that dtype (a bf16 matmul of the library may
    reduce in bf16 on the card; this one never does).  Other dtypes are
    a plain ``matmul``."""
    if a.dtype in (torch.bfloat16, torch.float16) and b.dtype == a.dtype:
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    return torch.matmul(a, b)


def build_shift_buffer(ifm: torch.Tensor, kw: int) -> torch.Tensor:
    """(..., IC, WI) -> X'(..., IC*KW, OI): row ic*KW+ci is I[ic] shifted by ci."""
    ic, wi = ifm.shape[-2:]
    oi = wi - kw + 1
    if oi <= 0:
        raise ValueError(f"input width {wi} < kernel width {kw}")
    shifted = ifm.unfold(-1, oi, 1)          # (..., IC, KW, OI)
    return shifted.reshape(*ifm.shape[:-2], ic * kw, oi)


def conv1d_dense_oracle(ifm: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Dense valid 1-D conv: (..., IC, WI) x (KW, IC, OC) -> (..., OC, OI)."""
    kw, ic, oc = kernel.shape
    x = build_shift_buffer(ifm, kw)
    w = kernel.permute(2, 1, 0).reshape(oc, ic * kw)   # W'
    return matmul_rounded(w, x.to(w.dtype))


@dataclasses.dataclass(frozen=True)
class PackedCoo:
    """COO kernel re-packed per output channel, padded to S = max nnz/oc
    with zero weights pointing at shift-buffer row 0 (no-op slots)."""

    w_pad: Union[np.ndarray, torch.Tensor]    # (OC, S) float32
    row_pad: Union[np.ndarray, torch.Tensor]  # (OC, S) int rows into X'
    kw: int
    ic: int
    oc: int

    @property
    def s(self) -> int:
        """Slots per output channel (the longest channel's nnz)."""
        return int(self.w_pad.shape[1])

    def to(self, device) -> "PackedCoo":
        """The same layout as tensors on ``device`` (for the hot path)."""
        return dataclasses.replace(
            self, w_pad=torch.as_tensor(self.w_pad, device=device),
            row_pad=torch.as_tensor(self.row_pad, dtype=torch.long,
                                    device=device))


def goap_pack(coo: CooKernel) -> PackedCoo:
    """Pack an (oc-major sorted) COO kernel into the padded (OC, S) layout."""
    oc_idx = (coo.row_idx // coo.ic).astype(np.int64)
    ic_idx = (coo.row_idx % coo.ic).astype(np.int64)
    counts = np.bincount(oc_idx, minlength=coo.oc) if coo.nnz else \
        np.zeros(coo.oc, dtype=np.int64)
    s = max(1, int(counts.max()) if counts.size else 1)
    w_pad = np.zeros((coo.oc, s), dtype=np.float32)
    row_pad = np.zeros((coo.oc, s), dtype=np.int32)
    if coo.nnz:
        if np.any(np.diff(oc_idx) < 0):
            raise ValueError("COO kernel is not sorted output-channel-major")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(coo.nnz) - starts[oc_idx]
        w_pad[oc_idx, slot] = coo.data.astype(np.float32)
        row_pad[oc_idx, slot] = ic_idx * coo.kw + coo.col_idx
    return PackedCoo(w_pad=w_pad, row_pad=row_pad,
                     kw=coo.kw, ic=coo.ic, oc=coo.oc)


def goap_conv_packed(ifm: torch.Tensor, pack: PackedCoo) -> torch.Tensor:
    """GOAP conv through the packed layout: one gather, one contraction."""
    dev = ifm.device
    w_pad = torch.as_tensor(pack.w_pad, device=dev)
    row_pad = torch.as_tensor(pack.row_pad, dtype=torch.long, device=dev)
    x = build_shift_buffer(ifm, pack.kw).to(torch.float32)  # (..., K, OI)
    ems = x[..., row_pad, :]                                # (..., OC, S, OI)
    return torch.einsum("os,...osk->...ok", w_pad, ems)


def goap_conv_nnz(ifm: torch.Tensor, coo: CooKernel) -> torch.Tensor:
    """Vectorized GOAP on a pre-padded (..., IC, WI) IFM: every non-zero
    weight w@(oc, ic, ci) adds ``w * I[ic, ci:ci+OI]`` (its enable map) to
    output row oc, gathered and scatter-added in f32."""
    wi = ifm.shape[-1]
    oi = wi - coo.kw + 1
    lead = ifm.shape[:-2]
    if coo.nnz == 0:
        return ifm.new_zeros(lead + (coo.oc, oi), dtype=torch.float32)
    dev = ifm.device
    w = torch.as_tensor(np.asarray(coo.data, dtype=np.float32), device=dev)
    oc_idx = torch.as_tensor((coo.row_idx // coo.ic).astype(np.int64), device=dev)
    ic_idx = torch.as_tensor((coo.row_idx % coo.ic).astype(np.int64), device=dev)
    cols = (torch.as_tensor(coo.col_idx.astype(np.int64), device=dev)[:, None]
            + torch.arange(oi, device=dev))                      # (nnz, OI)
    ems = ifm[..., ic_idx[:, None], cols].to(torch.float32)      # (..., nnz, OI)
    out = ifm.new_zeros(lead + (coo.oc, oi), dtype=torch.float32)
    return out.index_add_(-2, oc_idx, w[:, None] * ems)


@functools.lru_cache(maxsize=256)
def _reference_index_table(row_bytes: bytes, col_bytes: bytes, nnz: int,
                           kw: int, ic: int, wi: int):
    """Gather table of the vectorized emulator, cached on the COO indices."""
    row_idx = np.frombuffer(row_bytes, dtype=np.int32)
    col_idx = np.frombuffer(col_bytes, dtype=np.int32)
    oi = wi - kw + 1
    oc_idx = (row_idx // ic).astype(np.int64)
    ic_idx = (row_idx % ic).astype(np.int64)
    flat = (ic_idx[:, None] * wi + col_idx[:, None].astype(np.int64)
            + np.arange(oi, dtype=np.int64)[None, :])
    return oc_idx, flat


def goap_conv_reference(ifm: np.ndarray, coo: CooKernel) -> np.ndarray:
    """Algorithm-1 emulation in numpy float64 (tests, small shapes):
    ``np.add.at`` applies the contributions in COO order, so it equals
    :func:`goap_conv_reference_loop` bit for bit."""
    ifm = np.asarray(ifm)
    icn, wi = ifm.shape
    oi = wi - coo.kw + 1
    out = np.zeros((coo.oc, oi), dtype=np.float64)
    if coo.nnz == 0:
        return out
    oc_idx, flat = _reference_index_table(
        np.ascontiguousarray(coo.row_idx, dtype=np.int32).tobytes(),
        np.ascontiguousarray(coo.col_idx, dtype=np.int32).tobytes(),
        coo.nnz, coo.kw, icn, wi)
    gate = ifm.ravel()[flat] != 0                                # (nnz, OI)
    np.add.at(out, oc_idx, np.asarray(coo.data, np.float64)[:, None] * gate)
    return out


def goap_conv_reference_loop(ifm: np.ndarray, coo: CooKernel) -> np.ndarray:
    """The literal Algorithm-1 double loop (the bit-equality oracle of
    :func:`goap_conv_reference`)."""
    ifm = np.asarray(ifm)
    icn, wi = ifm.shape
    oi = wi - coo.kw + 1
    out = np.zeros((coo.oc, oi), dtype=np.float64)
    for n in range(coo.nnz):
        oc = int(coo.row_idx[n]) // icn
        ic = int(coo.row_idx[n]) % icn
        ci = int(coo.col_idx[n])
        w = float(coo.data[n])
        for o in range(oi):              # enable-map iteration
            if ifm[ic, o + ci] != 0:     # temporal-sparsity gate
                out[oc, o] += w
    return out
