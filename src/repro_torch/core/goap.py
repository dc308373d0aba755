"""Gated one-to-all product (GOAP) convolution (paper §III-C).

Port of ``repro/core/goap.py``.  The input feature map is pre-padded,
I: (..., IC, WI) binary; the kernel is (KW, IC, OC); the valid 1-D
convolution gives O: (..., OC, OI) with OI = WI - KW + 1.  Leading batch
dimensions are carried through (the reference vmaps instead).

``build_shift_buffer`` gives X'(IC*KW, OI) with X'[ic*KW + ci, oi] =
I[ic, oi + ci] (rows **ic-major**); the dense conv is ``W'(OC, IC*KW) @ X'``.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from .sparse_format import CooKernel

__all__ = ["build_shift_buffer", "conv1d_dense_oracle", "PackedCoo",
           "goap_pack", "goap_conv_packed"]


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
    return torch.matmul(w, x.to(w.dtype))


@dataclasses.dataclass(frozen=True)
class PackedCoo:
    """COO kernel re-packed per output channel, padded to S = max nnz/oc
    with zero weights pointing at shift-buffer row 0 (no-op slots)."""

    w_pad: Union[np.ndarray, torch.Tensor]    # (OC, S) float32
    row_pad: Union[np.ndarray, torch.Tensor]  # (OC, S) int rows into X'
    kw: int
    ic: int
    oc: int

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
