"""Fused LIF neuron update over time as a CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/lif_update.py::
lif_update_fused``: LIF over T for N neurons with the membrane resident
across T.  The kernel (``csrc/lif_update.cu``) gives one thread each
neuron and keeps its membrane in a register; device memory sees each
current read once and each spike written once.  It is a fused elementwise
pass, bound by bytes; the bounds check masks neurons past N, so nothing is
padded.

A CUDA tensor launches the kernel; a CPU tensor runs the plain version
:func:`lif_update_fused_ref`.  Both round ``alpha * v`` and ``+ current``
separately, so on the card their spikes agree exactly.

bf16 operands run the bf16 form, :func:`lif_update_fused_bf16` (its own
launch counter; ``lif_update_fused_bf16`` in ``csrc/lif_update.cu``): the
membrane in bf16, every op rounded to bf16 as the reference computes it,
spikes and final membrane in bf16.  The plain version is the same loop in
eager torch, which rounds each bf16 op on its own.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.launches import count_launch

__all__ = ["lif_update_fused", "lif_update_fused_ref", "lif_update_fused_bf16"]


def lif_update_fused_ref(currents, v0, alpha, theta, v_th):
    """Plain version: a loop over T of the core.lif update."""
    v = v0
    spikes = []
    for c in currents:
        v = alpha * v + c
        s = (v > v_th).to(v.dtype)
        v = v - theta * s
        spikes.append(s)
    return torch.stack(spikes) if spikes else currents.clone(), v


def _check(currents, v0, alpha, theta, v_th) -> None:
    if currents.dim() != 2:
        raise ValueError(f"currents must be (T, N), got {tuple(currents.shape)}")
    n = currents.shape[1]
    for name, a in (("currents", currents), ("v0", v0), ("alpha", alpha),
                    ("theta", theta), ("v_th", v_th)):
        if a.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got {a.dtype}")
        if a.dtype != currents.dtype:
            raise TypeError(f"{name} is {a.dtype}, currents {currents.dtype}")
        if a.device != currents.device:
            raise ValueError(f"{name} is on {a.device}, currents on {currents.device}")
        if a is not currents and tuple(a.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(a.shape)}")
    if currents.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {currents.device}")


def lif_update_fused(currents: torch.Tensor, v0: torch.Tensor,
                     alpha: torch.Tensor, theta: torch.Tensor,
                     v_th: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """currents (T, N), per-neuron (N,) vectors -> (spikes (T, N), v_fin (N,)),
    all float32 or all bfloat16 (:func:`lif_update_fused_bf16`)."""
    _check(currents, v0, alpha, theta, v_th)
    if currents.dtype == torch.bfloat16:
        return lif_update_fused_bf16(currents, v0, alpha, theta, v_th)
    if currents.device.type == "cpu":
        return lif_update_fused_ref(currents, v0, alpha, theta, v_th)
    return _launch("lif_update_fused_f32", lif_update_fused,
                   currents, v0, alpha, theta, v_th)


def lif_update_fused_bf16(currents: torch.Tensor, v0: torch.Tensor,
                          alpha: torch.Tensor, theta: torch.Tensor,
                          v_th: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 form: every operand bf16, the state and the outputs too."""
    _check(currents, v0, alpha, theta, v_th)
    if currents.dtype != torch.bfloat16:
        raise TypeError(f"currents must be bfloat16, got {currents.dtype}")
    if currents.device.type == "cpu":
        return lif_update_fused_ref(currents, v0, alpha, theta, v_th)
    return _launch("lif_update_fused_bf16", lif_update_fused_bf16,
                   currents, v0, alpha, theta, v_th)


def _launch(symbol: str, wrapper, currents, v0, alpha, theta, v_th):
    from repro_torch.kernels.build import check, kernel_function

    n = currents.shape[1]

    t = currents.shape[0]
    args = [a.contiguous() for a in (currents, v0, alpha, theta, v_th)]
    spikes = torch.empty_like(args[0])
    v_fin = torch.empty_like(args[1])
    if n == 0:
        return spikes, v_fin
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function(symbol, [vp, vp, vp, vp, vp, vp, vp, ci, ci, vp])
    err = fn(*(a.data_ptr() for a in args), spikes.data_ptr(),
             v_fin.data_ptr(), t, n,
             torch.cuda.current_stream(currents.device).cuda_stream)
    check(err, symbol)
    count_launch(wrapper)
    return spikes, v_fin


lif_update_fused.launches = 0
lif_update_fused_bf16.launches = 0
