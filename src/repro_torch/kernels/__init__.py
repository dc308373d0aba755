"""Hand-written CUDA kernels for Hopper, one per Pallas kernel of the reference.

=====================================  ====================================
reference Pallas kernel                port (wrapper -> CUDA source)
=====================================  ====================================
stream_fused.py::stream_fused_forward  stream_fused.py -> csrc/stream_fused.cu
goap_conv.py::goap_conv_block_sparse   goap_conv.py -> csrc/goap_conv.cu
wm_fc.py::wm_fc_matmul                 wm_fc.py -> csrc/wm_fc.cu
lif_update.py::lif_update_fused        lif_update.py -> csrc/lif_update.cu
=====================================  ====================================

Each wrapper checks its inputs, launches its kernel for CUDA tensors (the
library is built at first use by :mod:`.build`) and runs its plain
PyTorch version (``*_ref``, beside it) for CPU tensors.  Each wrapper
counts its launches in a plain int attribute, ``wrapper.launches``.
"""
from typing import Dict

from .goap_conv import (goap_conv_block_sparse, goap_conv_block_sparse_inorder,
                        goap_conv_block_sparse_ref)
from .lif_update import lif_update_fused, lif_update_fused_ref
from .ops import goap_conv_op, lif_op, wm_fc_op
from .stream_fused import stream_fused_forward, stream_fused_forward_ref
from .wm_fc import wm_fc_matmul, wm_fc_matmul_inorder, wm_fc_matmul_ref

__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "goap_conv_block_sparse",
    "goap_conv_block_sparse_ref",
    "goap_conv_block_sparse_inorder",
    "lif_update_fused",
    "lif_update_fused_ref",
    "wm_fc_matmul",
    "wm_fc_matmul_ref",
    "wm_fc_matmul_inorder",
    "stream_fused_forward",
    "stream_fused_forward_ref",
    "goap_conv_op",
    "wm_fc_op",
    "lif_op",
]

#: kernel name -> wrapper that launches it.
KERNELS = {
    "stream_fused_forward": stream_fused_forward,
    "goap_conv_block_sparse": goap_conv_block_sparse,
    "wm_fc_matmul": wm_fc_matmul,
    "lif_update_fused": lif_update_fused,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
