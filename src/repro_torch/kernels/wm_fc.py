"""Weight-masked FC layer as a CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/wm_fc.py::wm_fc_matmul``: a
``(B, IN) @ (IN, OUT)`` product whose left operand is {0, 1} spikes and
whose weights keep their pruned zeros.  Each output is a chain of IN
dependent adds, so on the H100 the adds and the shared-memory reads that
feed them set its pace, not its few bytes.  The kernel (``csrc/wm_fc.cu``)
gives one block a tile of batch rows x a tile of outputs and streams W
through shared memory once per block, in chunks of IN double-buffered with
cp.async, beside the same chunk of spikes; each lane walks its row's
inputs in order over 4 outputs, with one exact FFMA per weight where the
chunk's spikes are {0, 1}.  :func:`plan_wm_fc_launch` picks the tiles and
the shared memory.  The kernel equals :func:`wm_fc_matmul_inorder` bit for
bit.

A CUDA tensor launches the kernel; a CPU tensor runs the plain version
:func:`wm_fc_matmul_ref`.

With bf16 weights :func:`wm_fc_matmul` runs the reference's bf16 form,
:func:`wm_fc_matmul_bf16` (its own launch counter): the spikes are cast to
the weights' dtype, each 128-input tile's dot is accumulated in f32 and
rounded to bf16, and the tiles are summed in bf16, one rounding each
(:func:`wm_fc_matmul_bf16_ref`, the plain version).  The kernel
(``wm_fc_bf16`` in ``csrc/wm_fc.cu``) runs the tiles' dots on the tensor
cores (``mma.sync`` m16n8k16, f32 accumulators).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.goap import matmul_rounded
from repro_torch.kernels.launches import count_launch

__all__ = ["FCLaunch", "plan_wm_fc_launch", "wm_fc_matmul", "wm_fc_matmul_ref",
           "wm_fc_matmul_inorder", "wm_fc_matmul_bf16", "wm_fc_matmul_bf16_ref"]

MAX_SMEM = 232_448        # shared memory a block may use on the H100 (bytes)
MAX_THREADS = 256
ROWS = 16                 # batch rows per block (at least one warp's worth)
CHUNK = 128               # inputs per shared-memory chunk (as csrc/wm_fc.cu)
MAX_GRID_Y = 65_535       # output tiles lie on grid y
BF16_TILE = 128           # inputs per reference tile (wm_fc.py block_in)
DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class FCLaunch:
    """One launch of ``csrc/wm_fc.cu``: batch rows and outputs per block,
    threads per block, dynamic shared memory, grid."""
    rows: int
    out_tile: int
    threads: int
    smem_bytes: int
    grid: Tuple[int, int]


def plan_wm_fc_launch(batch: int, din: int, dout: int, *,
                      rows: Optional[int] = None,
                      out_tile: Optional[int] = None) -> FCLaunch:
    """The tiles and shared memory of one launch.

    Each lane owns one batch row x 4 outputs.  The output tile is the
    smallest power-of-two multiple of 4 that covers OUT, at most 32 (8
    lanes); the lanes left in a warp take further batch rows, so OUT = 11
    runs 8 rows a warp.  A block takes 16 batch rows (at least a warp's
    worth); the batch lies on grid x and is not capped."""
    if out_tile is None:
        groups = 1
        while groups < 8 and 4 * groups < dout:
            groups *= 2
        out_tile = 4 * groups
    groups = out_tile // 4
    if out_tile <= 0 or out_tile % 4 or 32 % groups:
        raise ValueError(f"out_tile {out_tile} must be 4, 8, 16, 32, 64 or 128")
    if rows is None:
        rows = max(ROWS, 32 // groups)
    threads = rows * groups
    if threads % 32 or threads > MAX_THREADS:
        raise ValueError(f"{rows} rows x {groups} lanes is not a whole number "
                         f"of warps up to {MAX_THREADS} threads")
    # two chunks of W and of the spikes, each spike row padded by 4 floats
    smem = 8 * CHUNK * (out_tile + rows) + 32 * rows
    if smem > MAX_SMEM:
        raise ValueError(f"a block needs {smem} bytes of shared memory; the "
                         f"H100 gives {MAX_SMEM}")
    grid = (-(-batch // rows), -(-dout // out_tile))
    if grid[1] > MAX_GRID_Y:
        raise ValueError(f"{dout} outputs need {grid[1]} output tiles; the "
                         f"grid takes {MAX_GRID_Y}")
    return FCLaunch(rows, out_tile, threads, smem, grid)


def wm_fc_matmul_ref(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain version: the f32 product, or the bf16 form's tile sums."""
    if weights.dtype == torch.bfloat16:
        return wm_fc_matmul_bf16_ref(spikes, weights)
    return spikes.to(weights.dtype) @ weights


def wm_fc_matmul_bf16_ref(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The reference's bf16 form: per 128-input tile an f32 dot rounded to
    bf16, added to the bf16 output with one more rounding."""
    s = spikes.to(weights.dtype)
    out = weights.new_zeros((s.shape[0], weights.shape[1]))
    for i0 in range(0, s.shape[1], BF16_TILE):
        out = out + matmul_rounded(s[:, i0:i0 + BF16_TILE],
                                   weights[i0:i0 + BF16_TILE])
    return out


def wm_fc_matmul_inorder(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The kernel's exact arithmetic in eager torch, one input at a time.

    Inputs are taken in ascending order; a non-zero spike adds
    ``spike * w``, multiply and add rounded separately, and a zero spike
    adds nothing.  On the card the kernel equals this bit for bit.
    """
    acc = weights.new_zeros((spikes.shape[0], weights.shape[1]))
    for i in range(spikes.shape[1]):
        s = spikes[:, i, None]
        acc = torch.where(s != 0, acc + s * weights[i], acc)
    return acc


def _check(spikes, weights) -> None:
    for name, a in (("spikes", spikes), ("weights", weights)):
        if a.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {a.dtype}")
    if spikes.dim() != 2 or weights.dim() != 2 or spikes.shape[1] != weights.shape[0]:
        raise ValueError(f"cannot multiply {tuple(spikes.shape)} by "
                         f"{tuple(weights.shape)}")
    if spikes.device != weights.device:
        raise ValueError("spikes and weights must share a device")
    if spikes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {spikes.device}")


def wm_fc_matmul(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """spikes (B, IN) binary @ weights (IN, OUT) masked -> (B, OUT), in the
    weights' dtype (float32, or bfloat16: :func:`wm_fc_matmul_bf16`)."""
    _check(spikes, weights)
    if weights.dtype == torch.bfloat16:
        return wm_fc_matmul_bf16(spikes, weights)
    spikes = spikes.to(weights.dtype)
    if spikes.device.type == "cpu":
        return wm_fc_matmul_ref(spikes, weights)
    return _launch(spikes, weights, plan_wm_fc_launch(
        spikes.shape[0], spikes.shape[1], weights.shape[1]))


def _launch(spikes, weights, plan: FCLaunch) -> torch.Tensor:
    from repro_torch.kernels.build import check, kernel_function

    b, din = spikes.shape
    dout = weights.shape[1]
    spikes = spikes.contiguous()
    weights = weights.contiguous()
    out = torch.empty((b, dout), dtype=torch.float32, device=spikes.device)
    if out.numel() == 0:
        return out
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("wm_fc_chunked_f32", [vp] * 3 + [ci] * 7 + [vp])
    err = fn(spikes.data_ptr(), weights.data_ptr(), out.data_ptr(), b, din,
             dout, plan.rows, plan.out_tile, plan.threads, plan.smem_bytes,
             torch.cuda.current_stream(spikes.device).cuda_stream)
    check(err, "wm_fc_chunked_f32")
    count_launch(wm_fc_matmul)
    return out


wm_fc_matmul.launches = 0


def wm_fc_matmul_bf16(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The bf16 form: spikes (B, IN) cast to bf16 @ bf16 weights (IN, OUT)
    -> bf16 (B, OUT), the reference's tile roundings."""
    _check(spikes, weights)
    if weights.dtype != torch.bfloat16:
        raise TypeError(f"weights must be bfloat16, got {weights.dtype}")
    spikes = spikes.to(torch.bfloat16)
    if spikes.device.type == "cpu":
        return wm_fc_matmul_bf16_ref(spikes, weights)
    from repro_torch.kernels.build import check, kernel_function

    b, din = spikes.shape
    dout = weights.shape[1]
    spikes = spikes.contiguous()
    weights = weights.contiguous()
    out = torch.empty((b, dout), dtype=torch.bfloat16, device=spikes.device)
    if out.numel() == 0:
        return out
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("wm_fc_bf16", [vp] * 3 + [ci] * 3 + [vp])
    err = fn(spikes.data_ptr(), weights.data_ptr(), out.data_ptr(), b, din,
             dout, torch.cuda.current_stream(spikes.device).cuda_stream)
    check(err, "wm_fc_bf16")
    count_launch(wm_fc_matmul_bf16)
    return out


wm_fc_matmul_bf16.launches = 0
