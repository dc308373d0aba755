"""Fused LIF neuron update over time as a CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/lif_update.py::
lif_update_fused``: LIF over T for N neurons with the membrane resident
across T.  The kernel (``csrc/lif_update.cu``) keeps each membrane in a
register; device memory sees each current read once and each spike and
final membrane written once.  It is a fused elementwise pass, bound by
bytes; the bounds check masks neurons past N, so nothing is padded.

Operands.  The reference's kernel takes (N,) vectors for ``alpha``,
``theta``, ``v_th`` and ``v0``.  Here the three parameters may be
per-channel (C,) vectors with an ``inner`` stride, neuron ``i`` reading
channel ``(i // inner) % C`` (an FC layer: C = OUT, inner = 1; a conv
layer's (OC, 1) parameters against (..., OC, W) currents: C = OC, inner =
W); the reference's (N,) form is C = N, inner = 1.  ``v0=None`` starts the
membrane at zero.  The kernel reads both forms as they are, so a caller
builds no operand on the card.

A CUDA tensor launches the kernel; a CPU tensor runs the plain version
:func:`lif_update_fused_ref`.  Both round ``alpha * v`` and ``+ current``
separately, so on the card their spikes agree exactly.

bf16 operands run the bf16 form, :func:`lif_update_fused_bf16` (its own
launch counter; ``lif_update_fused_bf16`` in ``csrc/lif_update.cu``): the
membrane in bf16, every op rounded to bf16 as the reference computes it,
spikes and final membrane in bf16.  A thread owns ``k`` adjacent neurons
and loads all their currents before its scan;
:func:`plan_lif_bf16_launch` picks ``k``, the currents loaded at once and
the threads a block.  The plain version is the same loop in eager torch,
which rounds each bf16 op on its own.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels.launches import count_launch

__all__ = ["LifBf16Launch", "plan_lif_bf16_launch", "lif_update_fused",
           "lif_update_fused_ref", "lif_update_fused_bf16"]

K_CHOICES = (8, 4, 2, 1)          # neurons a thread: 16 to 2 bytes a load
T_TILES = (1, 2, 4, 8, 16)        # currents of a neuron loaded before its scan
THREAD_CHOICES = (32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class LifBf16Launch:
    """One launch of the bf16 form: neurons a thread, currents of each
    loaded before the scan (longer T walks chunks of it), threads a block,
    blocks."""
    k: int
    t_tile: int
    threads: int
    grid: int


def plan_lif_bf16_launch(t: int, n: int, c: int, inner: int, n_sms: int, *,
                         k: Optional[int] = None, threads: Optional[int] = None,
                         align: int = 16) -> LifBf16Launch:
    """The launch of the bf16 form for T x N currents over C channels
    (``inner`` their stride; a thread finds its channels itself, so the
    layout does not change the plan).

    ``align`` is the byte alignment the operands share: a thread's loads
    and stores are ``2 * k`` bytes wide, so ``k`` divides N and ``2 * k``
    divides ``align``.  By default ``k`` is the widest that still leaves
    8 warps of threads an SM, else 1, and the block 128 threads where that
    still gives every SM a block, else 64: FC1 (T 8 x N 8,192) runs k 1 in
    128 blocks, FC2 (N 704) k 1 in 11, a conv layer (N 131,072) k 2 in
    512.  In the sweep (``python -m repro_torch.kernels.sweep --kernels
    lif``) these were the fastest or within 3% of it; plans a few percent
    apart swap places between calls, and wide ``k`` in few blocks lost up
    to 35%.  ``t_tile`` covers T up to 16.  Raises where the kernel has
    no instance for the plan."""
    t_tile = next((tt for tt in T_TILES if tt >= t), T_TILES[-1])
    fits = [kk for kk in K_CHOICES if n % kk == 0 and align % (2 * kk) == 0]
    if k is None:
        k = next((kk for kk in fits if n // kk >= 8 * 32 * n_sms), 1)
    if k not in K_CHOICES:
        raise ValueError(f"k {k} must be one of {K_CHOICES}")
    if k not in fits:
        raise ValueError(f"k {k} does not divide N {n} or its {2 * k}-byte "
                         f"loads are off the operands' {align}-byte alignment")
    groups = n // k
    if threads is None:
        threads = 128 if -(-groups // 128) >= n_sms else 64
    if threads not in THREAD_CHOICES:
        raise ValueError(f"threads {threads} must be one of {THREAD_CHOICES}")
    return LifBf16Launch(k, t_tile, threads, max(1, -(-groups // threads)))


def per_neuron(p: torch.Tensor, n: int, inner: int = 1) -> torch.Tensor:
    """A (C,) per-channel vector as the (N,) vector it stands for: neuron
    ``i`` takes channel ``(i // inner) % C``."""
    if p.shape[0] == n and inner == 1:
        return p
    return p[(torch.arange(n, device=p.device) // inner) % p.shape[0]]


def lif_update_fused_ref(currents, v0, alpha, theta, v_th, *, inner: int = 1):
    """Plain version: a loop over T of the core.lif update, the parameters
    expanded to one per neuron."""
    n = currents.shape[1]
    alpha, theta, v_th = (per_neuron(p, n, inner) for p in (alpha, theta, v_th))
    v = currents.new_zeros((n,)) if v0 is None else v0
    spikes = []
    for c in currents:
        v = alpha * v + c
        s = (v > v_th).to(v.dtype)
        v = v - theta * s
        spikes.append(s)
    return torch.stack(spikes) if spikes else currents.clone(), v


def _check(currents, v0, alpha, theta, v_th, inner) -> None:
    if currents.dim() != 2:
        raise ValueError(f"currents must be (T, N), got {tuple(currents.shape)}")
    n = currents.shape[1]
    named = (("currents", currents), ("v0", v0), ("alpha", alpha),
             ("theta", theta), ("v_th", v_th))
    for name, a in named:
        if a is None and name == "v0":
            continue
        if a.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got {a.dtype}")
        if a.dtype != currents.dtype:
            raise TypeError(f"{name} is {a.dtype}, currents {currents.dtype}")
        if a.device != currents.device:
            raise ValueError(f"{name} is on {a.device}, currents on {currents.device}")
    if v0 is not None and tuple(v0.shape) != (n,):
        raise ValueError(f"v0 must be ({n},) or None, got {tuple(v0.shape)}")
    c = alpha.shape[0] if alpha.dim() == 1 else 0
    for name, a in (("alpha", alpha), ("theta", theta), ("v_th", v_th)):
        if a.dim() != 1 or a.shape[0] != c or c == 0:
            raise ValueError(f"{name} must be a (C,) vector, C as alpha's, "
                             f"got {tuple(a.shape)}")
    if isinstance(inner, bool) or not isinstance(inner, int) or inner < 1:
        raise ValueError(f"inner must be a positive int, got {inner!r}")
    if n % (c * inner):
        raise ValueError(f"{n} neurons are not whole groups of {c} channels "
                         f"x inner {inner}")
    if currents.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {currents.device}")


def lif_update_fused(currents: torch.Tensor, v0: Optional[torch.Tensor],
                     alpha: torch.Tensor, theta: torch.Tensor,
                     v_th: torch.Tensor, *, inner: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """currents (T, N), parameters (C,) read per channel (``inner``; the
    reference's (N,) vectors are C = N), v0 (N,) or None (zero) ->
    (spikes (T, N), v_fin (N,)), all float32 or all bfloat16
    (:func:`lif_update_fused_bf16`)."""
    _check(currents, v0, alpha, theta, v_th, inner)
    if currents.dtype == torch.bfloat16:
        return lif_update_fused_bf16(currents, v0, alpha, theta, v_th, inner=inner)
    if currents.device.type == "cpu":
        return lif_update_fused_ref(currents, v0, alpha, theta, v_th, inner=inner)
    return _launch_f32(currents, v0, alpha, theta, v_th, inner)


def lif_update_fused_bf16(currents: torch.Tensor, v0: Optional[torch.Tensor],
                          alpha: torch.Tensor, theta: torch.Tensor,
                          v_th: torch.Tensor, *, inner: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 form: every operand bf16, the state and the outputs too."""
    _check(currents, v0, alpha, theta, v_th, inner)
    if currents.dtype != torch.bfloat16:
        raise TypeError(f"currents must be bfloat16, got {currents.dtype}")
    if currents.device.type == "cpu":
        return lif_update_fused_ref(currents, v0, alpha, theta, v_th, inner=inner)
    from repro_torch.kernels.goap_conv import _n_sms

    currents = currents.contiguous()
    v0 = None if v0 is None else v0.contiguous()
    t, n = currents.shape
    plan = plan_lif_bf16_launch(t, n, alpha.shape[0], inner,
                                _n_sms(currents.device),
                                align=_alignment(currents, v0))
    return _launch_bf16(currents, v0, alpha, theta, v_th, inner, plan)


def _alignment(*tensors) -> int:
    """The largest power of two up to 16 that divides every tensor's address."""
    align = 16
    for a in tensors:
        if a is not None:
            ptr = a.data_ptr()
            align = min(align, ptr & -ptr) if ptr else align
    return align


def _outputs(currents):
    return torch.empty_like(currents), torch.empty(
        currents.shape[1:], dtype=currents.dtype, device=currents.device)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(a) -> Optional[int]:
    return None if a is None else a.data_ptr()


def _launch_f32(currents, v0, alpha, theta, v_th, inner):
    from repro_torch.kernels.build import check, kernel_function

    currents = currents.contiguous()
    v0, alpha, theta, v_th = (None if a is None else a.contiguous()
                              for a in (v0, alpha, theta, v_th))
    t, n = currents.shape
    spikes, v_fin = _outputs(currents)
    if n == 0:
        return spikes, v_fin
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("lif_update_fused_f32", [vp] * 7 + [ci] * 4 + [vp])
    err = fn(currents.data_ptr(), _ptr(v0), alpha.data_ptr(), theta.data_ptr(),
             v_th.data_ptr(), spikes.data_ptr(), v_fin.data_ptr(), t, n,
             alpha.shape[0], inner, _stream(currents))
    check(err, "lif_update_fused_f32")
    count_launch(lif_update_fused)
    return spikes, v_fin


def _launch_bf16(currents, v0, alpha, theta, v_th, inner, plan: LifBf16Launch):
    """Launch the bf16 form with ``plan`` (the sweep forces one here)."""
    from repro_torch.kernels.build import check, kernel_function

    currents = currents.contiguous()
    v0, alpha, theta, v_th = (None if a is None else a.contiguous()
                              for a in (v0, alpha, theta, v_th))
    t, n = currents.shape
    spikes, v_fin = _outputs(currents)
    if n == 0:
        return spikes, v_fin
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("lif_update_fused_bf16", [vp] * 7 + [ci] * 7 + [vp])
    err = fn(currents.data_ptr(), _ptr(v0), alpha.data_ptr(), theta.data_ptr(),
             v_th.data_ptr(), spikes.data_ptr(), v_fin.data_ptr(), t, n,
             alpha.shape[0], inner, plan.k, plan.t_tile, plan.threads,
             _stream(currents))
    check(err, "lif_update_fused_bf16")
    count_launch(lif_update_fused_bf16)
    return spikes, v_fin


lif_update_fused.launches = 0
lif_update_fused_bf16.launches = 0
