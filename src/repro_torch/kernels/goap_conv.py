"""Static block-sparse GOAP conv product as a CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/goap_conv.py::
goap_conv_block_sparse``: ``W'(OC, K) @ X'(K, OI)`` over (block_oc x
block_k) tiles, each oc-tile row's tile list padded with zero tiles that
point at k-tile 0.  On the H100 it is bound by the bytes of X' and of the
output.  The kernel (``csrc/goap_conv.cu``) gives a block every output row
and a run of strips of X' columns: each strip is copied into shared memory
once (cp.async, the next strip in flight while one is walked), so each X'
element leaves device memory once per launch, and each thread walks its
rows' tile lists in list order from shared memory.
:func:`plan_goap_conv_launch` picks the strip width, rows per thread, grid
and shared memory, and raises where a block would need more than the card
gives.  A k-tile index outside X' poisons its rows with NaN instead of
being read (no host synchronisation).  The kernel equals
:func:`goap_conv_block_sparse_inorder` bit for bit.

A CUDA tensor launches the kernel; a CPU tensor runs the plain version
:func:`goap_conv_block_sparse_ref` (the port of ``repro/kernels/ref.py``).

bf16 tiles and X' run the reference's bf16 form,
:func:`goap_conv_block_sparse_bf16` (its own launch counter;
``goap_conv_bf16`` in ``csrc/goap_conv.cu``, on the tensor cores): each
tile slot's dot accumulated in f32, rounded to bf16 and added to the bf16
output with one more rounding, slot by slot
(:func:`goap_conv_block_sparse_bf16_ref`).  Its kernel is laid out as the
f32 one: a block owns every oc-tile x a strip of X' columns, copied once
with 16-byte ``cp.async`` while the previous strip runs through
``mma.sync``; :func:`plan_goap_conv_bf16_launch` picks the strip, grid and
shared memory.  The served conv never reaches it (``ops.goap_conv_op``
casts to f32, as the reference's does); it is the kernel's contract.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.goap import matmul_rounded
from repro_torch.kernels.launches import count_launch

__all__ = ["ConvLaunch", "plan_goap_conv_launch", "ConvBf16Launch",
           "plan_goap_conv_bf16_launch", "goap_conv_block_sparse",
           "goap_conv_block_sparse_ref", "goap_conv_block_sparse_inorder",
           "goap_conv_block_sparse_bf16", "goap_conv_block_sparse_bf16_ref",
           "dense_of_blocks"]

MAX_SMEM = 232_448        # shared memory a block may use on the H100 (bytes)
SM_SMEM = 233_472         # shared memory of one SM; the card keeps 1 KB per block
SM_THREADS = 2048
N_SMS = 132               # SMs of an H100 SXM (the wrapper asks the card)
STRIP = 256               # widest strip of X' columns per block
MIN_STRIP = 32
MAX_THREADS = 256
DTYPES = (torch.float32, torch.bfloat16)
BF16_MAX_BO = 32          # csrc/goap_conv.cu: BO up to 4 n8 fragments
BF16_STRIPS = (256, 128, 64)       # X' columns a strip: 64-column rows
BF16_MAX_WARPS = 16
BF16_REGS = 128           # registers a thread of the bf16 kernel may take (512 threads)
SM_REGS = 65_536


@dataclasses.dataclass(frozen=True)
class ConvLaunch:
    """One launch of ``csrc/goap_conv.cu``: X' columns per strip, output
    rows per thread, blocks (each walks strips ``b, b + blocks, ...``),
    threads per block and dynamic shared memory."""
    strip: int
    rows_per_thread: int
    blocks: int
    threads: int
    smem_bytes: int


def plan_goap_conv_launch(n_oc_tiles: int, max_tiles: int, bo: int, bk: int,
                          k_pad: int, oi: int, *, n_sms: int = N_SMS,
                          strip: Optional[int] = None,
                          rows_per_thread: Optional[int] = None) -> ConvLaunch:
    """The strip, rows per thread, grid and shared memory of one launch.

    A block holds two strips of X' (``k_pad x strip`` f32 each: one walked,
    the next in flight) and all weight tiles and tile indices in shared
    memory; a thread owns ``rows_per_thread`` rows (8 or 4, or the largest
    of 2, 1 that divides block_oc) x 4 columns of a strip.  Among the strips
    of 256 down to 32 columns (no wider than OI needs) whose block fits, it
    takes the one with the most threads up to 256, then the most rows per
    thread (fewer loads per accumulation), then the widest: the walk is
    bound by how many warps hide its shared-memory latency and by the loads
    each accumulation needs (``python -m repro_torch.kernels.sweep``).  Past
    227 KB it raises rather than launch a kernel the card refuses.  The
    grid is as many blocks as fit on the card at once, at most one per
    strip."""
    def smem(width):
        return 4 * (2 * k_pad * width + n_oc_tiles * max_tiles * (bo * bk + 1))

    def items(width, rb):
        return n_oc_tiles * (bo // rb) * (width // 4)

    rbs = ([r for r in (8, 4) if bo % r == 0]
           or [next(r for r in (2, 1) if bo % r == 0)])
    if rows_per_thread is not None:
        if rows_per_thread not in (8, 4, 2, 1) or bo % rows_per_thread:
            raise ValueError(f"rows_per_thread {rows_per_thread} does not "
                             f"divide block_oc {bo} or is not 1, 2, 4 or 8")
        rbs = [rows_per_thread]
    if strip is None:
        widest = STRIP
        while widest > 4 and widest // 2 >= oi:    # no wider than OI needs
            widest //= 2
        strips = [w for w in (256, 128, 64, 32, 16, 8, 4)
                  if w <= widest and (w >= MIN_STRIP or w == widest)]
        fits = [(items(w, rb), rb, w) for w in strips for rb in rbs
                if smem(w) <= MAX_SMEM and items(w, rb) <= MAX_THREADS]
        if fits:
            _, rb, strip = max(fits)
            rbs = [rb]
        else:   # more items than threads even at the narrowest strip
            strip = strips[-1]
    if strip <= 0 or strip % 4:
        raise ValueError(f"strip {strip} is not a positive multiple of 4")
    if smem(strip) > MAX_SMEM:
        raise ValueError(
            f"a block needs {smem(strip)} bytes of shared memory (2 x K_pad "
            f"{k_pad} x {strip} columns of X' and {n_oc_tiles * max_tiles} "
            f"tiles of {bo}x{bk}); the H100 gives {MAX_SMEM}")
    rb = rbs[0]
    threads = min(MAX_THREADS, max(32, -(-items(strip, rb) // 32) * 32))
    resident = min(SM_SMEM // (smem(strip) + 1024), SM_THREADS // threads)
    blocks = max(1, min(-(-oi // strip), resident * n_sms))
    return ConvLaunch(strip, rb, blocks, threads, smem(strip))


@dataclasses.dataclass(frozen=True)
class ConvBf16Launch:
    """One launch of the bf16 kernel (``goap_conv_bf16``): X' columns per
    strip, blocks (each walks strips ``b, b + blocks, ...``), threads per
    block and dynamic shared memory."""
    strip: int
    blocks: int
    threads: int
    smem_bytes: int


def conv_bf16_smem(n_oc_tiles: int, max_tiles: int, bo: int, bk: int,
                   n_k_tiles: int, strip: int) -> int:
    """Shared memory of one block of the bf16 kernel (``csrc/goap_conv.cu``
    ``bf_smem``): two strips of X' (each k-tile's rows padded to a multiple
    of 16, unpadded 128-byte rows swizzled), the tiles (BO padded to 8
    rows, BK to a multiple of 16 plus 8) and the output tile (rows padded
    by 8 values) in bf16; then the tile indices."""
    bkp, bop = -(-bk // 16) * 16, -(-bo // 8) * 8
    return (2 * (2 * n_k_tiles * bkp * strip
                 + n_oc_tiles * max_tiles * bop * (bkp + 8)
                 + n_oc_tiles * bop * (strip + 8))
            + 4 * n_oc_tiles * max_tiles)


def conv_bf16_groups(bo: int) -> int:
    """16-column groups a warp item of the bf16 kernel computes together
    (``csrc/goap_conv.cu`` ``bf_groups``): 4 up to BO = 16, else 2."""
    return 4 if bo <= 16 else 2


def plan_goap_conv_bf16_launch(n_oc_tiles: int, max_tiles: int, bo: int,
                               bk: int, k_pad: int, oi: int, *,
                               n_sms: int = N_SMS,
                               strip: Optional[int] = None) -> ConvBf16Launch:
    """The strip, grid, threads and shared memory of one launch of the
    bf16 form.

    A block holds two strips of X' (one computed, the next in flight), all
    the tiles and an output tile in shared memory; a strip is 64, 128 or
    256 columns (rows of 64 swizzled), and the block's warps (up to 16, no
    more than it has items) walk (oc-tile, 16 x ``conv_bf16_groups(bo)``
    columns) items.  By default the widest strip whose block fits and that
    still gives nine SMs in ten a strip, else the narrowest that fits: X'
    leaves device memory once whatever the strip, so the strip trades the
    block's fixed costs (its tiles, barriers) and its warps against SMs
    left idle (``python -m repro_torch.kernels.sweep --kernels bf16``:
    conv3's 128 strips of 128 columns beat 256 of 64).  The grid is as
    many blocks as fit on the card at once, at most one per strip (on grid
    x).  Raises past 227 KB or for BO above 32."""
    if bo <= 0 or bo > BF16_MAX_BO:
        raise ValueError(f"block_oc {bo} is not 1 to {BF16_MAX_BO}: the bf16 "
                         "kernel holds at most 4 n8 fragments")
    n_k = k_pad // bk
    item = 16 * conv_bf16_groups(bo)

    def smem(width):
        return conv_bf16_smem(n_oc_tiles, max_tiles, bo, bk, n_k, width)

    if strip is None:
        widest = max(BF16_STRIPS[-1], min(BF16_STRIPS[0], -(-oi // 64) * 64))
        fits = [w for w in BF16_STRIPS if w <= widest and smem(w) <= MAX_SMEM]
        strip = next((w for w in fits if -(-oi // w) >= 0.9 * n_sms),
                     fits[-1] if fits else BF16_STRIPS[-1])
    if strip not in BF16_STRIPS:
        raise ValueError(f"strip {strip} is not one of {BF16_STRIPS}")
    if smem(strip) > MAX_SMEM:
        raise ValueError(
            f"a block needs {smem(strip)} bytes of shared memory (2 x {n_k} "
            f"k-tiles x {strip} columns of X', {n_oc_tiles * max_tiles} tiles "
            f"of {bo}x{bk} and the output tile); the H100 gives {MAX_SMEM}")
    threads = 32 * max(1, min(BF16_MAX_WARPS, n_oc_tiles * strip // item))
    resident = max(1, min(SM_SMEM // (smem(strip) + 1024), SM_THREADS // threads,
                          SM_REGS // (BF16_REGS * threads)))
    blocks = max(1, min(-(-oi // strip), resident * n_sms))
    return ConvBf16Launch(strip, blocks, threads, smem(strip))


def goap_conv_block_sparse_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                               x: torch.Tensor) -> torch.Tensor:
    """out[r*BO:(r+1)*BO] = sum_t blocks[r, t] @ x[cols[r,t]*BK : +BK]
    (bf16 operands: :func:`goap_conv_block_sparse_bf16_ref`)."""
    if blocks.dtype == torch.bfloat16:
        return goap_conv_block_sparse_bf16_ref(blocks, block_cols, x)
    n_oc_tiles, max_tiles, bo, bk = blocks.shape
    xt = x.reshape(-1, bk, x.shape[1])                  # (n_k_tiles, BK, OI)
    tiles = xt[block_cols.long()]                       # (R, MT, BK, OI)
    out = torch.einsum("rtok,rtki->roi", blocks, tiles.to(blocks.dtype))
    return out.reshape(n_oc_tiles * bo, x.shape[1])


def goap_conv_block_sparse_inorder(blocks: torch.Tensor,
                                   block_cols: torch.Tensor,
                                   x: torch.Tensor) -> torch.Tensor:
    """The kernel's exact arithmetic in eager torch, one term at a time.

    Each row walks its tile list in list order and each tile in k order;
    a non-zero ``x`` adds ``w * x``, multiply and add rounded separately,
    and a zero ``x`` adds nothing.  A k-tile index outside X' makes its
    oc-tile's rows NaN.  On the card the kernel equals this bit for bit.
    """
    n_oc_tiles, max_tiles, bo, bk = blocks.shape
    n_k, oi = x.shape[0] // bk, x.shape[1]
    cols = block_cols.long()
    bad = ((cols < 0) | (cols >= n_k)).any(1)
    acc = x.new_zeros((n_oc_tiles, bo, oi))
    if n_k:
        xt = x.reshape(n_k, bk, oi)[cols.clamp(0, n_k - 1)]    # (R, MT, BK, OI)
        for t in range(max_tiles):
            for k in range(bk):
                xv = xt[:, t, k, None, :]                     # (R, 1, OI)
                wv = blocks[:, t, :, k, None]                 # (R, BO, 1)
                acc = torch.where(xv != 0, acc + wv * xv, acc)
    acc = torch.where(bad[:, None, None], float("nan"), acc)
    return acc.reshape(n_oc_tiles * bo, oi)


def goap_conv_block_sparse_bf16_ref(blocks: torch.Tensor,
                                    block_cols: torch.Tensor,
                                    x: torch.Tensor) -> torch.Tensor:
    """The reference's bf16 form: per tile slot, in list order, an f32 dot
    rounded to bf16 and added to the bf16 output with one more rounding.
    A k-tile index outside X' makes its oc-tile's rows NaN (as the kernel)."""
    n_oc_tiles, max_tiles, bo, bk = blocks.shape
    n_k, oi = x.shape[0] // bk, x.shape[1]
    cols = block_cols.long()
    bad = ((cols < 0) | (cols >= n_k)).any(1)
    out = blocks.new_zeros((n_oc_tiles, bo, oi))
    if n_k:
        xt = x.reshape(n_k, bk, oi).to(blocks.dtype)[cols.clamp(0, n_k - 1)]
        for t in range(max_tiles):
            out = out + matmul_rounded(blocks[:, t], xt[:, t])
    out = torch.where(bad[:, None, None], float("nan"), out)
    return out.reshape(n_oc_tiles * bo, oi)


def dense_of_blocks(blocks: torch.Tensor, block_cols: torch.Tensor,
                    k_pad: int) -> torch.Tensor:
    """The dense padded W' (n_oc_tiles * BO, K_pad) that block-sparse tiles
    stand for (zero tiles add nothing): the operand of the one
    ``torch.matmul`` that computes the same product."""
    n_oc_tiles, _, bo, bk = blocks.shape
    dense = blocks.new_zeros((n_oc_tiles, bo, k_pad // bk, bk))
    for r, row in enumerate(block_cols.tolist()):
        for t, c in enumerate(row):
            dense[r, :, c] += blocks[r, t]
    return dense.reshape(n_oc_tiles * bo, k_pad)


def _check(blocks, block_cols, x, block_oc, block_k):
    for name, a in (("blocks", blocks), ("x", x)):
        if a.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {a.dtype}")
    if x.dtype != blocks.dtype:
        raise TypeError(f"x is {x.dtype}, blocks {blocks.dtype}")
    if blocks.dim() != 4 or tuple(blocks.shape[2:]) != (block_oc, block_k):
        raise ValueError(f"blocks {tuple(blocks.shape)} do not hold "
                         f"({block_oc}, {block_k}) tiles")
    if tuple(block_cols.shape) != tuple(blocks.shape[:2]):
        raise ValueError(f"block_cols {tuple(block_cols.shape)} != "
                         f"{tuple(blocks.shape[:2])}")
    if x.dim() != 2 or x.shape[0] % block_k:
        raise ValueError(f"x {tuple(x.shape)}: rows must be a multiple of "
                         f"block_k={block_k}")
    if not (blocks.device == block_cols.device == x.device):
        raise ValueError("blocks, block_cols and x must share a device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def goap_conv_block_sparse(blocks: torch.Tensor, block_cols: torch.Tensor,
                           x: torch.Tensor, *, block_oc: int, block_k: int
                           ) -> torch.Tensor:
    """Currents (n_oc_tiles * BO, OI) = block-sparse W' @ X', in the
    operands' dtype (float32, or bfloat16: :func:`goap_conv_block_sparse_bf16`)."""
    _check(blocks, block_cols, x, block_oc, block_k)
    if blocks.dtype == torch.bfloat16:
        return goap_conv_block_sparse_bf16(blocks, block_cols, x,
                                           block_oc=block_oc, block_k=block_k)
    if x.device.type == "cpu":
        return goap_conv_block_sparse_ref(blocks, block_cols, x)
    return _launch(blocks, block_cols, x, plan_goap_conv_launch(
        *blocks.shape, x.shape[0], x.shape[1], n_sms=_n_sms(x.device)))


@functools.lru_cache(maxsize=None)
def _n_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(blocks, block_cols, x, plan: ConvLaunch) -> torch.Tensor:
    from repro_torch.kernels.build import check, kernel_function

    n_oc_tiles, max_tiles, bo, bk = blocks.shape
    oi = x.shape[1]
    blocks = blocks.contiguous()
    cols = block_cols.to(torch.int32).contiguous()
    x = x.contiguous()
    out = torch.empty((n_oc_tiles * bo, oi), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("goap_conv_strips_f32", [vp] * 4 + [ci] * 11 + [vp])
    err = fn(blocks.data_ptr(), cols.data_ptr(), x.data_ptr(), out.data_ptr(),
             n_oc_tiles, max_tiles, bo, bk, x.shape[0] // bk, oi, plan.strip,
             plan.rows_per_thread, plan.blocks, plan.threads, plan.smem_bytes,
             torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "goap_conv_strips_f32")
    count_launch(goap_conv_block_sparse)
    return out


goap_conv_block_sparse.launches = 0


def goap_conv_block_sparse_bf16(blocks: torch.Tensor, block_cols: torch.Tensor,
                                x: torch.Tensor, *, block_oc: int, block_k: int
                                ) -> torch.Tensor:
    """The bf16 form: bf16 tiles and X' -> bf16 currents (n_oc_tiles * BO, OI)."""
    _check(blocks, block_cols, x, block_oc, block_k)
    if blocks.dtype != torch.bfloat16:
        raise TypeError(f"blocks must be bfloat16, got {blocks.dtype}")
    if x.device.type == "cpu":
        return goap_conv_block_sparse_bf16_ref(blocks, block_cols, x)
    return _launch_bf16(blocks, block_cols, x, plan_goap_conv_bf16_launch(
        *blocks.shape, x.shape[0], x.shape[1], n_sms=_n_sms(x.device)))


def _launch_bf16(blocks, block_cols, x, plan: ConvBf16Launch) -> torch.Tensor:
    from repro_torch.kernels.build import check, kernel_function

    n_oc_tiles, max_tiles, bo, bk = blocks.shape
    oi = x.shape[1]
    blocks = blocks.contiguous()
    cols = block_cols.to(torch.int32).contiguous()
    x = x.contiguous()
    out = torch.empty((n_oc_tiles * bo, oi), dtype=torch.bfloat16,
                      device=x.device)
    if out.numel() == 0:
        return out
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("goap_conv_bf16", [vp] * 4 + [ci] * 10 + [vp])
    err = fn(blocks.data_ptr(), cols.data_ptr(), x.data_ptr(), out.data_ptr(),
             n_oc_tiles, max_tiles, bo, bk, x.shape[0] // bk, oi, plan.strip,
             plan.blocks, plan.threads, plan.smem_bytes,
             torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "goap_conv_bf16")
    count_launch(goap_conv_block_sparse_bf16)
    return out


goap_conv_block_sparse_bf16.launches = 0
