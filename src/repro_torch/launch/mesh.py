"""Production mesh definitions and the machine model of the roofline (an
NVIDIA H100 SXM 80GB).

Port of ``repro/launch/mesh.py``.  The meshes are the reference's layouts
as :class:`~repro_torch.distributed.sharding.Mesh` objects: arithmetic
(axis names and sizes), since no machine here holds 256 or 512 cards;
:func:`make_dev_mesh` can also build the ``DeviceMesh`` of a small mesh
inside a process group of that many ranks.

Axes:
    single-pod  (16, 16)      -> ("data", "model")        256 chips
    multi-pod   (2, 16, 16)   -> ("pod", "data", "model") 512 chips

``pod`` composes with ``data`` for batch sharding (pure DP across pods);
``model`` carries TP/SP/EP (see :mod:`repro_torch.distributed.sharding`).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.distributed.sharding import Mesh

__all__ = ["make_production_mesh", "make_dev_mesh", "HW"]


# One NVIDIA H100 SXM 80GB, from NVIDIA's H100 Tensor Core GPU data sheet
# (dense rates, without sparsity, at the 700 W power limit):
# * peak_flops_bf16: the bf16 tensor-core peak, 989 TFLOP/s;
# * hbm_bw: HBM3 bandwidth, 3.35 TB/s;
# * link_bw: NVLink 4, whose 900 GB/s is the aggregate of both directions
#   over the card's 18 links; a ring collective's wire bytes leave a card
#   in one direction, so the figure used is the per-direction 450 GB/s
#   (the role the reference's per-link ICI figure plays);
# * hbm_bytes: 80 GB (decimal, as the data sheet states it).
HW = {
    "name": "h100-sxm-80gb",
    "peak_flops_bf16": 989e12,     # FLOP/s
    "hbm_bw": 3.35e12,             # B/s
    "link_bw": 450e9,              # B/s, NVLink per direction
    "hbm_bytes": 80 * 10**9,
}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_dev_mesh(data: int = 2, model: int = 4,
                  device_type: Optional[str] = None) -> Mesh:
    """A small ``("data", "model")`` mesh; with ``device_type`` (inside a
    process group of ``data * model`` ranks) it carries a ``DeviceMesh``."""
    return Mesh((data, model), ("data", "model"), device_type=device_type)
