"""Static block-sparse GOAP conv product as a CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/goap_conv.py::
goap_conv_block_sparse``: ``W'(OC, K) @ X'(K, OI)`` over (block_oc x
block_k) tiles, each oc-tile row's tile list padded with zero tiles that
point at k-tile 0.  The kernel (``csrc/goap_conv.cu``) gives one thread
each output element, walking its row's tiles in order; weight loads are
warp broadcasts and X' loads coalesce along OI.  It is bound by bytes;
this first version reads X' once per output row.  A k-tile index outside
X' poisons its output row with NaN instead of reading out of bounds (the
check costs no host synchronisation).

A CUDA tensor launches the kernel; a CPU tensor runs the plain version
:func:`goap_conv_block_sparse_ref` (the port of ``repro/kernels/ref.py``).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["goap_conv_block_sparse", "goap_conv_block_sparse_ref"]


def goap_conv_block_sparse_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                               x: torch.Tensor) -> torch.Tensor:
    """out[r*BO:(r+1)*BO] = sum_t blocks[r, t] @ x[cols[r,t]*BK : +BK]."""
    n_oc_tiles, max_tiles, bo, bk = blocks.shape
    xt = x.reshape(-1, bk, x.shape[1])                  # (n_k_tiles, BK, OI)
    tiles = xt[block_cols.long()]                       # (R, MT, BK, OI)
    out = torch.einsum("rtok,rtki->roi", blocks, tiles.to(blocks.dtype))
    return out.reshape(n_oc_tiles * bo, x.shape[1])


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
    from repro_torch.kernels.build import check, kernel_function

    n_oc_tiles, max_tiles, bo, bk = blocks.shape
    oi = x.shape[1]
    if n_oc_tiles * bo > 65535:
        raise ValueError(f"{n_oc_tiles * bo} output rows exceed the grid")
    blocks = blocks.contiguous()
    cols = block_cols.to(torch.int32).contiguous()
    x = x.contiguous()
    out = torch.empty((n_oc_tiles * bo, oi), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("goap_conv_block_sparse_f32",
                         [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp])
    err = fn(blocks.data_ptr(), cols.data_ptr(), x.data_ptr(), out.data_ptr(),
             n_oc_tiles, max_tiles, bo, bk, x.shape[0] // bk, oi,
             torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "goap_conv_block_sparse_f32")
    goap_conv_block_sparse.launches += 1
    return out


goap_conv_block_sparse.launches = 0
