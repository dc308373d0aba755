"""Framework-facing wrappers around the per-layer kernels.

Port of ``repro/kernels/ops.py``: they take the model-level objects
(``BlockSparseKernel``, pre-padded IFMs, ``LIFParams``) and do the layout
plumbing around the raw kernels.  Each wrapper accepts leading batch
dimensions, which the reference handles with ``vmap``: the conv folds them
into the OI axis of X', the FC into its batch rows and the LIF into its
neuron axis, so a whole batch (or a whole T x batch sequence) is one
launch.  They run wherever their input lies (kernel on the card, plain
version on the CPU).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.goap import build_shift_buffer
from repro_torch.core.lif import LIFParams
from repro_torch.core.sparse_format import BlockSparseKernel

from .goap_conv import goap_conv_block_sparse
from .lif_update import lif_update_fused
from .wm_fc import wm_fc_matmul

__all__ = ["block_sparse_to", "goap_conv_op", "wm_fc_op", "lif_op"]


def block_sparse_to(bs: BlockSparseKernel, device) -> BlockSparseKernel:
    """The same tiling with its kernel operands as tensors on ``device``."""
    return dataclasses.replace(
        bs, blocks=torch.as_tensor(bs.blocks, dtype=torch.float32, device=device),
        block_cols=torch.as_tensor(bs.block_cols, dtype=torch.int32,
                                   device=device))


def goap_conv_op(ifm: torch.Tensor, bs: BlockSparseKernel) -> torch.Tensor:
    """Sparse conv currents (..., OC, OI) of a pre-padded (..., IC, WI) IFM.

    The leading dims fold into the OI axis of X', and K is padded to the
    blocked reduction size."""
    *lead, ic, wi = ifm.shape
    if ic != bs.ic:
        raise ValueError(f"IFM has {ic} channels, kernel expects {bs.ic}")
    oi = wi - bs.kw + 1
    n = math.prod(lead)
    x = build_shift_buffer(ifm, bs.kw).to(torch.float32)      # (..., K, OI)
    x = x.reshape(n, bs.k, oi).permute(1, 0, 2).reshape(bs.k, n * oi)
    x = F.pad(x, (0, 0, 0, bs.padded_k - bs.k))
    dev = ifm.device
    out = goap_conv_block_sparse(
        torch.as_tensor(bs.blocks, dtype=torch.float32, device=dev),
        torch.as_tensor(bs.block_cols, dtype=torch.int32, device=dev), x,
        block_oc=bs.block_oc, block_k=bs.block_k)
    out = out[: bs.oc].reshape(bs.oc, -1, oi).permute(1, 0, 2)
    return out.reshape(*lead, bs.oc, oi)


def wm_fc_op(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(..., IN) binary @ (IN, OUT) masked -> (..., OUT)."""
    lead = spikes.shape[:-1]
    out = wm_fc_matmul(spikes.reshape(-1, spikes.shape[-1]), weights)
    return out.reshape(*lead, weights.shape[1])


def lif_op(currents: torch.Tensor, params: LIFParams,
           v0: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LIF over time for any neuron shape: (T, ...) -> (spikes, v_fin)."""
    t = currents.shape[0]
    neuron_shape = currents.shape[1:]
    cur = currents.reshape(t, -1)
    n = cur.shape[1]

    def full(p):
        return torch.broadcast_to(p, neuron_shape).reshape(-1).contiguous()

    v0f = (torch.zeros((n,), dtype=cur.dtype, device=cur.device)
           if v0 is None else v0.reshape(-1))
    spikes, v_fin = lif_update_fused(cur, v0f, full(params.alpha),
                                     full(params.theta), full(params.v_th))
    return spikes.reshape((t,) + neuron_shape), v_fin.reshape(neuron_shape)
