"""Weight-masked FC layer as a CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/wm_fc.py::wm_fc_matmul``: a
``(B, IN) @ (IN, OUT)`` product whose left operand is {0, 1} spikes and
whose weights keep their pruned zeros.  The kernel (``csrc/wm_fc.cu``)
gives one thread each output and fetches a weight only where the input
spike is set — the paper's FM = IFM AND WM rule.  It is bound by the bytes
of the fetched weight rows; no padding is needed.

A CUDA tensor launches the kernel; a CPU tensor runs the plain version
:func:`wm_fc_matmul_ref`.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["wm_fc_matmul", "wm_fc_matmul_ref"]


def wm_fc_matmul_ref(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return spikes.to(weights.dtype) @ weights


def wm_fc_matmul(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """spikes (B, IN) binary @ weights (IN, OUT) masked -> (B, OUT)."""
    for name, a in (("spikes", spikes), ("weights", weights)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
    if spikes.dim() != 2 or weights.dim() != 2 or spikes.shape[1] != weights.shape[0]:
        raise ValueError(f"cannot multiply {tuple(spikes.shape)} by "
                         f"{tuple(weights.shape)}")
    if spikes.device != weights.device:
        raise ValueError("spikes and weights must share a device")
    if spikes.device.type == "cpu":
        return wm_fc_matmul_ref(spikes, weights)
    if spikes.device.type != "cuda":
        raise ValueError(f"unsupported device {spikes.device}")
    from repro_torch.kernels.build import check, kernel_function

    b, din = spikes.shape
    dout = weights.shape[1]
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid")
    spikes = spikes.contiguous()
    weights = weights.contiguous()
    out = torch.empty((b, dout), dtype=torch.float32, device=spikes.device)
    if out.numel() == 0:
        return out.zero_()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("wm_fc_matmul_f32", [vp, vp, vp, ci, ci, ci, vp])
    err = fn(spikes.data_ptr(), weights.data_ptr(), out.data_ptr(), b, din,
             dout, torch.cuda.current_stream(spikes.device).cuda_stream)
    check(err, "wm_fc_matmul_f32")
    wm_fc_matmul.launches += 1
    return out


wm_fc_matmul.launches = 0
