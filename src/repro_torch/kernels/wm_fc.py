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
(``wm_fc_bf16`` in ``csrc/wm_fc.cu``) gives a block a tile of batch rows x
outputs and one warp to each reference tile of IN: each warp stages its
tile with 16-byte ``cp.async`` and runs its dot on the tensor cores
(``mma.sync`` m16n8k16, f32 accumulators), and the block adds the rounded
dots in ascending tile order.  :func:`plan_wm_fc_bf16_launch` picks the
tiles, the warps and the shared memory.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.goap import matmul_rounded
from repro_torch.kernels.launches import count_launch

__all__ = ["FCLaunch", "plan_wm_fc_launch", "FCBf16Launch", "plan_wm_fc_bf16_launch",
           "wm_fc_matmul", "wm_fc_matmul_ref", "wm_fc_matmul_inorder",
           "wm_fc_matmul_bf16", "wm_fc_matmul_bf16_ref"]

MAX_SMEM = 232_448        # shared memory a block may use on the H100 (bytes)
MAX_THREADS = 256
ROWS = 16                 # batch rows per block (at least one warp's worth)
CHUNK = 128               # inputs per shared-memory chunk (as csrc/wm_fc.cu)
MAX_GRID_Y = 65_535       # output tiles lie on grid y
BF16_TILE = 128           # inputs per reference tile (wm_fc.py block_in)
BF16_MAX_SPLIT = 8        # warps a block of the bf16 kernel (one tile each)
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


@dataclasses.dataclass(frozen=True)
class FCBf16Launch:
    """One launch of the bf16 kernel (``wm_fc_bf16``): batch rows and
    outputs per block, warps per block (each takes one 128-input reference
    tile of a round), threads, dynamic shared memory, grid."""
    rows: int
    out_tile: int
    split: int
    threads: int
    smem_bytes: int
    grid: Tuple[int, int]


def fc_bf16_smem(rows: int, out_tile: int, split: int) -> int:
    """Shared memory of one block of the bf16 kernel (``csrc/wm_fc.cu``
    ``bf_smem``): per warp its tile's spikes (rows x 136 bf16) and weights
    (128 x (out_tile + 8) bf16), then the warps' dots (f32, rows
    padded by 8) and the block's accumulators (f32)."""
    return (split * 2 * (rows * (BF16_TILE + 8) + BF16_TILE * (out_tile + 8))
            + 4 * (split * rows * (out_tile + 8) + rows * out_tile))


def plan_wm_fc_bf16_launch(batch: int, din: int, dout: int, *,
                           rows: Optional[int] = None,
                           out_tile: Optional[int] = None,
                           split: Optional[int] = None) -> FCBf16Launch:
    """The tiles, warps and shared memory of one launch of the bf16 form.

    A block owns ``rows`` (16 or 32) batch rows x ``out_tile`` (16, 32 or
    64) outputs; its ``split`` warps (up to 8, no more than IN has 128-input
    tiles) take one reference tile each, and IN beyond ``split`` tiles takes
    further rounds.  By default 16 rows, and the output tile is 16 where
    OUT fits in it, else 32, so FC1 (512 x 1024 x 128) runs 128 blocks of
    8 warps and FC2 (OUT = 11) 32 blocks of one: in the sweep (``python -m
    repro_torch.kernels.sweep --kernels bf16``) 256 blocks of 16 outputs
    were slower on FC1, each re-reading its rows' spikes from L2 twice as
    often.  The batch lies on grid x (uncapped), the output tiles on grid
    y (at most 65,535).  Raises where the card would refuse the launch."""
    n_tiles = -(-din // BF16_TILE)
    if rows is None:
        rows = 16
    if out_tile is None:
        out_tile = 16 if dout <= 16 else 32
    if split is None:
        split = max(1, min(BF16_MAX_SPLIT, n_tiles))
    if rows not in (16, 32):
        raise ValueError(f"rows {rows} must be 16 or 32")
    if out_tile not in (16, 32, 64):
        raise ValueError(f"out_tile {out_tile} must be 16, 32 or 64")
    if not 1 <= split <= BF16_MAX_SPLIT:
        raise ValueError(f"split {split} must be 1 to {BF16_MAX_SPLIT} warps")
    smem = fc_bf16_smem(rows, out_tile, split)
    if smem > MAX_SMEM:
        raise ValueError(f"a block needs {smem} bytes of shared memory; the "
                         f"H100 gives {MAX_SMEM}")
    grid = (-(-batch // rows), -(-dout // out_tile))
    if grid[1] > MAX_GRID_Y:
        raise ValueError(f"{dout} outputs need {grid[1]} output tiles; the "
                         f"grid takes {MAX_GRID_Y}")
    return FCBf16Launch(rows, out_tile, split, 32 * split, smem, grid)


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
    return _launch_bf16(spikes, weights, plan_wm_fc_bf16_launch(
        spikes.shape[0], spikes.shape[1], weights.shape[1]))


def _launch_bf16(spikes, weights, plan: FCBf16Launch) -> torch.Tensor:
    from repro_torch.kernels.build import check, kernel_function

    b, din = spikes.shape
    dout = weights.shape[1]
    spikes = spikes.contiguous()
    weights = weights.contiguous()
    out = torch.empty((b, dout), dtype=torch.bfloat16, device=spikes.device)
    if out.numel() == 0:
        return out
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("wm_fc_bf16", [vp] * 3 + [ci] * 8 + [vp])
    err = fn(spikes.data_ptr(), weights.data_ptr(), out.data_ptr(), b, din,
             dout, plan.rows, plan.out_tile, plan.split, plan.threads,
             plan.smem_bytes, torch.cuda.current_stream(spikes.device).cuda_stream)
    check(err, "wm_fc_bf16")
    count_launch(wm_fc_matmul_bf16)
    return out


wm_fc_matmul_bf16.launches = 0
