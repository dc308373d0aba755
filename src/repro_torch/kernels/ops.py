"""Framework-facing wrappers around the per-layer kernels.

Port of ``repro/kernels/ops.py``: they take the model-level objects
(``BlockSparseKernel``, pre-padded IFMs, ``LIFParams``) and do the layout
plumbing around the raw kernels.  Each wrapper accepts leading batch
dimensions, which the reference handles with ``vmap``: the conv folds them
into the OI axis of X', the FC into its batch rows and the LIF into its
neuron axis, so a whole batch (or a whole T x batch sequence) is one
launch.  They run wherever their input lies (kernel on the card, plain
version on the CPU).

Dtypes are the reference's: the conv casts its operands to f32 (as
``repro/kernels/ops.py`` does), the FC runs in the weights' dtype with the
spikes cast to it, and the LIF runs in the currents' dtype with the
parameters cast to it where that is exact (bf16 parameters against f32
currents: the reference promotes them, which is the same values).

The LIF's operands: the reference broadcasts each parameter to the neuron
shape and starts the membrane from a zeros vector, on every call.  Here
:func:`lif_operands` makes a layer's parameters once, in its membrane's
dtype (a ``cuda`` cell does so when it is built), and :func:`lif_op`
hands them to the kernel as per-channel vectors with their ``inner``
stride and no ``v0``: a call builds nothing on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.goap import build_shift_buffer
from repro_torch.core.lif import LIFParams
from repro_torch.core.sparse_format import BlockSparseKernel

from .goap_conv import goap_conv_block_sparse
from .lif_update import lif_update_fused
from .wm_fc import wm_fc_matmul

__all__ = ["block_sparse_to", "goap_conv_op", "wm_fc_op", "LIFOperands",
           "lif_operands", "channel_layout", "lif_op"]


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
    """(..., IN) binary @ (IN, OUT) masked -> (..., OUT) in the weights'
    dtype (the spikes cast to it, as the reference's graph casts them)."""
    lead = spikes.shape[:-1]
    s = spikes.reshape(-1, spikes.shape[-1]).to(weights.dtype)
    out = wm_fc_matmul(s, weights)
    return out.reshape(*lead, weights.shape[1])


@dataclasses.dataclass(frozen=True)
class LIFOperands:
    """A LIF layer's kernel operands for one membrane dtype: the decay as
    ``alpha_for(dtype)``, ``theta`` and ``v_th``, all of one contiguous
    shape (the parameters' broadcast shape), in that dtype."""
    alpha: torch.Tensor
    theta: torch.Tensor
    v_th: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.alpha.dtype


def lif_operands(params: LIFParams, dtype: torch.dtype) -> LIFOperands:
    """``params`` as operands of a membrane in ``dtype``, made once.

    Parameters wider than the membrane (f32 against bf16: the reference
    would round once per step there) are refused."""
    values = (params.alpha_for(dtype), params.theta, params.v_th)
    for p in values:
        if p.dtype != dtype and not (dtype == torch.float32
                                     and p.dtype == torch.bfloat16):
            raise TypeError(f"LIF parameters in {p.dtype} against "
                            f"{dtype} currents")
    shape = torch.broadcast_shapes(*(p.shape for p in values))
    return LIFOperands(*(torch.broadcast_to(p.to(dtype), shape).contiguous()
                         for p in values))


def channel_layout(param_shape, neuron_shape) -> Optional[Tuple[int, int]]:
    """(C, inner) of parameters of ``param_shape`` broadcast over
    ``neuron_shape``, flattened: neuron ``i`` takes parameter ``(i // inner)
    % C``.  That holds where the dims the parameters vary over are one run
    of ``neuron_shape``'s; else None."""
    if len(param_shape) > len(neuron_shape):
        return None
    p = (1,) * (len(neuron_shape) - len(param_shape)) + tuple(param_shape)
    varying = [d for d, size in enumerate(p) if size != 1]
    if not varying:
        return 1, 1
    lo, hi = varying[0], varying[-1]
    if any(p[d] != neuron_shape[d] for d in range(lo, hi + 1)):
        return None
    return math.prod(neuron_shape[lo:hi + 1]), math.prod(neuron_shape[hi + 1:])


def lif_op(currents: torch.Tensor, params: Union[LIFParams, LIFOperands],
           v0: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LIF over time for any neuron shape: (T, ...) -> (spikes, v_fin),
    in the currents' dtype.  ``params`` are a layer's ``LIFParams`` (made
    into operands on each call) or its :class:`LIFOperands` (made once, in
    the currents' dtype).  Parameters wider than the currents (f32 against
    bf16 currents: the reference would round once per step there) are
    refused."""
    t = currents.shape[0]
    neuron_shape = currents.shape[1:]
    cur = currents.reshape(t, -1)
    ops = (params if isinstance(params, LIFOperands)
           else lif_operands(params, cur.dtype))
    if ops.dtype != cur.dtype:
        raise TypeError(f"LIF operands in {ops.dtype} against {cur.dtype} "
                        "currents")
    layout = channel_layout(ops.alpha.shape, neuron_shape)
    if layout is None:     # not one run of channels: one value per neuron
        vectors = [torch.broadcast_to(p, neuron_shape).reshape(-1).contiguous()
                   for p in (ops.alpha, ops.theta, ops.v_th)]
        inner = 1
    else:
        vectors = [p.reshape(-1) for p in (ops.alpha, ops.theta, ops.v_th)]
        inner = layout[1]
    v0f = None if v0 is None else v0.reshape(-1).to(cur.dtype)
    spikes, v_fin = lif_update_fused(cur, v0f, *vectors, inner=inner)
    return spikes.reshape((t,) + neuron_shape), v_fin.reshape(neuron_shape)
