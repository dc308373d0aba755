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
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

__all__ = ["lif_update_fused", "lif_update_fused_ref"]


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


def lif_update_fused(currents: torch.Tensor, v0: torch.Tensor,
                     alpha: torch.Tensor, theta: torch.Tensor,
                     v_th: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """currents (T, N), per-neuron (N,) vectors -> (spikes (T, N), v_fin (N,))."""
    if currents.dim() != 2:
        raise ValueError(f"currents must be (T, N), got {tuple(currents.shape)}")
    n = currents.shape[1]
    for name, a in (("currents", currents), ("v0", v0), ("alpha", alpha),
                    ("theta", theta), ("v_th", v_th)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != currents.device:
            raise ValueError(f"{name} is on {a.device}, currents on {currents.device}")
        if a is not currents and tuple(a.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(a.shape)}")
    if currents.device.type == "cpu":
        return lif_update_fused_ref(currents, v0, alpha, theta, v_th)
    if currents.device.type != "cuda":
        raise ValueError(f"unsupported device {currents.device}")
    from repro_torch.kernels.build import check, kernel_function

    t = currents.shape[0]
    args = [a.contiguous() for a in (currents, v0, alpha, theta, v_th)]
    spikes = torch.empty_like(args[0])
    v_fin = torch.empty_like(args[1])
    if n == 0:
        return spikes, v_fin
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("lif_update_fused_f32",
                         [vp, vp, vp, vp, vp, vp, vp, ci, ci, vp])
    err = fn(*(a.data_ptr() for a in args), spikes.data_ptr(),
             v_fin.data_ptr(), t, n,
             torch.cuda.current_stream(currents.device).cuda_stream)
    check(err, "lif_update_fused_f32")
    lif_update_fused.launches += 1
    return spikes, v_fin


lif_update_fused.launches = 0
