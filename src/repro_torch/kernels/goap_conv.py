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
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

__all__ = ["ConvLaunch", "plan_goap_conv_launch", "goap_conv_block_sparse",
           "goap_conv_block_sparse_ref", "goap_conv_block_sparse_inorder",
           "dense_of_blocks"]

MAX_SMEM = 232_448        # shared memory a block may use on the H100 (bytes)
SM_SMEM = 233_472         # shared memory of one SM; the card keeps 1 KB per block
SM_THREADS = 2048
N_SMS = 132               # SMs of an H100 SXM (the wrapper asks the card)
STRIP = 256               # widest strip of X' columns per block
MIN_STRIP = 32
MAX_THREADS = 256


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


def goap_conv_block_sparse_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                               x: torch.Tensor) -> torch.Tensor:
    """out[r*BO:(r+1)*BO] = sum_t blocks[r, t] @ x[cols[r,t]*BK : +BK]."""
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
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
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


def goap_conv_block_sparse(blocks: torch.Tensor, block_cols: torch.Tensor,
                           x: torch.Tensor, *, block_oc: int, block_k: int
                           ) -> torch.Tensor:
    """Currents (n_oc_tiles * BO, OI) = block-sparse W' @ X'."""
    _check(blocks, block_cols, x, block_oc, block_k)
    if x.device.type == "cpu":
        return goap_conv_block_sparse_ref(blocks, block_cols, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
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
    goap_conv_block_sparse.launches += 1
    return out


goap_conv_block_sparse.launches = 0
