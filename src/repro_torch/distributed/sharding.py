"""Parameter / activation / state sharding rules (DP x TP x SP x EP) and
the serving mesh.

Port of ``repro/distributed/sharding.py``.  One rule table covers every
assigned architecture.  Rules are keyed on the *path* of each leaf in the
parameter tree (``"stacks/0/attn/wq"``: the keys
``jax.tree_util.tree_map_with_path`` spells, :mod:`repro_torch.tree`) and
are **divisibility checked**: a dim is sharded only when the mesh axis
divides it, otherwise that dim falls back to replication.  Stacked-layer
leading axes are auto-detected by rule arity and left unsharded.

Scheme (Megatron-style TP over ``model``, DP over ``pod x data``, FSDP of
the largest still-unsharded weight dim over ``data``; expert parallelism
where ``E % model == 0``, TP inside the experts otherwise) and every rule
are the reference's; see its module docstring for the table.

``PartitionSpec`` has no torch counterpart.  :class:`PartitionSpec` here
is a tuple with one entry per tensor dim (``None``, an axis name, or a
tuple of axis names), printed as the reference prints its specs, and
:class:`Mesh` stands for the reference's ``Mesh`` / ``AbstractMesh``: axis
names and sizes, and optionally a ``torch.distributed`` ``DeviceMesh`` of
the same layout.  A 512-"chip" production mesh is arithmetic, not
devices.  :func:`named_tree` pairs each spec with its mesh; on a mesh with
a ``DeviceMesh`` a :class:`NamedSharding` places a tensor as a DTensor
(``Shard`` on the dim an axis names, ``Replicate`` elsewhere).

The serving half (:func:`serve_mesh`, :func:`serve_batch_pspec`,
:func:`shard_serve_fn`) is pure data parallelism over the local cards:
the SNN is tiny, so the only axis worth splitting is the request batch.
:class:`ServeMesh` stands for the reference's 1-D ``("data",)`` mesh.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.tree import (tree_leaves, tree_leaves_with_path, tree_map,
                              tree_unflatten)

__all__ = [
    "dp_axes",
    "partition_params",
    "named_tree",
    "train_batch_spec",
    "act_pspec",
    "logits_pspec",
    "decode_state_specs",
    "spec_report",
    "serve_mesh",
    "serve_batch_pspec",
    "shard_serve_fn",
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "ServeMesh",
    "split_batch",
]


# ---------------------------------------------------------------------------
# specs and meshes
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (the dim split over their product, major first).
    Equal to the plain tuple of its entries; normalised and printed as
    ``jax.sharding.PartitionSpec`` (``("data",)`` is ``"data"``, ``()`` is
    ``None``)."""

    def __new__(cls, *dims):
        def norm(d):
            if isinstance(d, (tuple, list)):
                return None if not d else (d[0] if len(d) == 1 else tuple(d))
            return d
        return super().__new__(cls, tuple(norm(d) for d in dims))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    __str__ = __repr__


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


class Mesh:
    """A named device mesh: ``axis_names`` and their sizes (``shape``, in
    axis order), and, where ``device_type`` is given, the matching
    ``torch.distributed`` ``DeviceMesh`` (``device_mesh``; it needs a
    process group of ``size`` ranks).  Without one the mesh is arithmetic:
    what the sharding rules and the dry-run count with."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 device_type: Optional[str] = None):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for {len(axis_names)} "
                             "axis names")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, axis_sizes)))
        self.device_mesh = None
        if device_type is not None:
            from torch.distributed.device_mesh import init_device_mesh

            self.device_mesh = init_device_mesh(
                device_type, tuple(self.shape.values()),
                mesh_dim_names=self.axis_names)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}{', devices' if self.device_mesh else ''})"


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def placements(self):
        """DTensor placements, one per mesh axis: ``Shard(d)`` for the
        tensor dim ``d`` whose entry names the axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, entry in enumerate(self.spec)
                    if entry == axis or (isinstance(entry, tuple)
                                         and axis in entry)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def place(self, tensor: torch.Tensor):
        """``tensor`` (the same on every rank) as a DTensor laid out by the
        spec over the mesh's ``DeviceMesh``."""
        if self.mesh.device_mesh is None:
            raise ValueError(f"{self.mesh} has no DeviceMesh to place on; "
                             "build it with device_type=")
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(tensor, self.mesh.device_mesh,
                                 self.placements())

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The per-device shape of a tensor of ``shape`` under the spec."""
        return tuple(dim // _axis_size(self.mesh, entry)
                     for dim, entry in zip(shape, tuple(self.spec)
                                           + (None,) * (len(shape)
                                                        - len(self.spec))))

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------

def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes: pod composes with data when present."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _check(spec_dims: Sequence, shape: Sequence[int], mesh: Mesh):
    """Replicate any dim whose size the assigned axis does not divide."""
    return tuple(ax if (ax is not None and dim % _axis_size(mesh, ax) == 0)
                 else None for ax, dim in zip(spec_dims, shape))


def _rules(model: str):
    """(regex over the '/'-joined leaf path, rule for the LAST dims); the
    first match wins.  The reference's table, entry for entry."""
    return [
        # embeddings (vocab-parallel; vocab padded to 128-multiples)
        (r"(^|/)tok$",          (model, None)),
        (r"(^|/)unemb$",        "unemb"),
        (r"(^|/)pos$",          (None, model)),
        # attention
        (r"(^|/)(wq|wk|wv)$",   "attn_col"),
        (r"(^|/)(bq|bk|bv)$",   "attn_bias"),
        (r"(^|/)wo$",           "attn_row"),
        (r"(^|/)(q_norm|k_norm)$", None),
        # MoE (before the dense MLP rules)
        (r"moe/(wg|wu)$",       "moe_up"),
        (r"moe/wd$",            "moe_down"),
        (r"(^|/)router$",       None),
        # dense MLP (swiglu + whisper mlp)
        (r"(^|/)(wg|wu|wi|w1)$", (None, model)),
        (r"(^|/)(wd|w2)$",      (model, None)),
        (r"(^|/)b1$",           (model,)),
        (r"(^|/)dec_pos$",      (None, model)),
        # RG-LRU
        (r"rglru/(w_x|w_gate)$", (None, model)),
        (r"rglru/conv$",        (None, model)),
        (r"rglru/(w_r|w_i)$",   (model, None, None)),  # block-diag (nb, wb, wb)
        (r"rglru/w_out$",       (model, None)),
        (r"rglru/lam$",         (model,)),
        # Mamba-2: the fused in-proj's segments are not tile-aligned
        (r"ssm/",               None),
        # whisper conv-frontend stub / layernorm scale+bias / defaults
        (r".*",                 None),
    ]


def _spec_for(path: str, shape: Tuple[int, ...], mesh: Mesh, model: str,
              n_experts: int, head_dim: int = 0) -> PartitionSpec:
    n_model = _axis_size(mesh, model)
    for pat, rule in _rules(model):
        if not re.search(pat, path):
            continue
        if rule is None:
            return PartitionSpec()
        if rule == "attn_col":       # (d, H*hd)
            dims = (None, model) if shape[-1] % n_model == 0 else (None, None)
        elif rule == "attn_bias":    # (H*hd,)
            dims = (model,) if shape[-1] % n_model == 0 else (None,)
        elif rule == "attn_row":     # (H*hd, d)
            dims = (model, None) if shape[-2] % n_model == 0 else (None, None)
        elif rule == "unemb":        # (d, V): vocab-sharded logits, else row
            dims = (None, model) if shape[-1] % n_model == 0 else (model, None)
        elif rule in ("moe_up", "moe_down"):   # (E, d, f) / (E, f, d)
            if n_experts and n_experts % n_model == 0:
                dims = (model, None, None)
            else:
                dims = (None, None, model) if rule == "moe_up" \
                    else (None, model, None)
        else:
            dims = rule
        dims = dims[-len(shape):] if len(dims) > len(shape) else dims
        pad = (None,) * (len(shape) - len(dims))
        return PartitionSpec(*_check(pad + tuple(dims), shape, mesh))
    return PartitionSpec()


def partition_params(shape_tree: Any, mesh: Mesh, *, model_axis: str = "model",
                     n_experts: int = 0, head_dim: int = 0,
                     fsdp_axis: Optional[str] = "data") -> Any:
    """PartitionSpec tree for a parameter (or grad / optimizer-state) tree;
    its leaves need only ``.shape`` (meta tensors do).

    ``fsdp_axis``: after the TP rules assign ``model``, the largest
    still-unsharded non-stack dim of every >=2-D weight is sharded over
    the data axis (ZeRO-3), except a dim that would fracture attention
    heads; ``None`` keeps weights resident.  ``pod`` stays pure DP.
    """
    fsdp_n = mesh.shape.get(fsdp_axis, 1) if fsdp_axis else 1

    def visit(keys, leaf):
        shape = tuple(leaf.shape)
        spec = _spec_for("/".join(keys), shape, mesh, model_axis, n_experts,
                         head_dim)
        blocked = set()
        leaf_name = keys[-1] if keys else ""
        if head_dim and leaf_name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
            h_i = len(shape) - (2 if leaf_name == "wo" else 1)
            if shape[h_i] % fsdp_n or (shape[h_i] // fsdp_n) % head_dim:
                blocked.add(h_i)
        if fsdp_axis and fsdp_n > 1 and len(shape) >= 2:
            dims = list(spec) + [None] * (len(shape) - len(spec))
            # never dim 0 of a rank>=3 leaf (the layer-stack axis); the
            # largest unsharded dim the fsdp axis divides
            lo = 1 if len(shape) >= 3 else 0
            cands = [(shape[i], i) for i in range(len(shape) - 1, lo - 1, -1)
                     if dims[i] is None and shape[i] % fsdp_n == 0
                     and shape[i] >= 2 * fsdp_n and i not in blocked]
            if cands:
                _, i = max(cands)
                dims[i] = fsdp_axis
                spec = PartitionSpec(*dims)
        return spec

    pairs = tree_leaves_with_path(shape_tree)
    return tree_unflatten(shape_tree, [visit(k, leaf) for k, leaf in pairs])


def named_tree(spec_tree: Any, mesh: Mesh) -> Any:
    """Each spec of ``spec_tree`` as a :class:`NamedSharding` on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                    is_leaf=_is_spec)


# ---------------------------------------------------------------------------
# activations / batches / decode state
# ---------------------------------------------------------------------------

def _dp_or_none(mesh: Mesh, batch: int):
    dp = dp_axes(mesh)
    return dp if batch % _axis_size(mesh, dp) == 0 else None


def train_batch_spec(mesh: Mesh, batch: int, *, rank: int = 2) -> PartitionSpec:
    """(B, S, ...) input batch: B over the DP axes when divisible."""
    return PartitionSpec(_dp_or_none(mesh, batch), *(None,) * (rank - 1))


def act_pspec(mesh: Mesh, batch: int, seq: int, *,
              seq_shard: bool = True) -> PartitionSpec:
    """Residual stream (B, S, d): B over DP, S over model (sequence
    parallelism)."""
    s_ax = "model" if (seq_shard and seq % _axis_size(mesh, "model") == 0) \
        else None
    return PartitionSpec(_dp_or_none(mesh, batch), s_ax, None)


def logits_pspec(mesh: Mesh, batch: int, seq: int, vocab: int) -> PartitionSpec:
    """Logits (B, S, V): vocab-shard when divisible, else sequence-shard."""
    dp = _dp_or_none(mesh, batch)
    if vocab % _axis_size(mesh, "model") == 0:
        return PartitionSpec(dp, None, "model")
    s_ax = "model" if seq % _axis_size(mesh, "model") == 0 else None
    return PartitionSpec(dp, s_ax, None)


def decode_state_specs(state_tree: Any, mesh: Mesh, batch: int) -> Any:
    """Decode-state sharding: KV caches (L, B, CTX, nkv, hd) shard B over
    DP and CTX over model; their int8 scales (L, B, CTX, nkv) follow the
    cache; SSM / LRU / conv states shard B over DP and the last dim over
    model when divisible."""
    dp = _dp_or_none(mesh, batch)
    dp_n = max(1, _axis_size(mesh, dp))
    model_n = _axis_size(mesh, "model")

    def visit(keys, leaf):
        name = keys[-1] if keys else ""
        shape = tuple(leaf.shape)
        if name == "len" or len(shape) == 0:
            return PartitionSpec()
        if name in ("k", "v", "ck", "cv") and len(shape) >= 4:
            ctx_ax = "model" if shape[-3] % model_n == 0 else None
            lead = (None,) * (len(shape) - 4)
            return PartitionSpec(*lead, dp if shape[-4] % dp_n == 0 and dp
                                 else None, ctx_ax, None, None)
        if name in ("k_scale", "v_scale") and len(shape) >= 3:
            ctx_ax = "model" if shape[-2] % model_n == 0 else None
            lead = (None,) * (len(shape) - 3)
            return PartitionSpec(*lead, dp if shape[-3] % dp_n == 0 and dp
                                 else None, ctx_ax, None)
        # generic state: (L, B, ...)
        dims = [None] * len(shape)
        if len(shape) >= 2:
            dims[1] = dp if dp and shape[1] % _axis_size(mesh, dp) == 0 else None
        if shape[-1] % model_n == 0 and len(shape) >= 3:
            dims[-1] = "model"
        return PartitionSpec(*dims)

    pairs = tree_leaves_with_path(state_tree)
    return tree_unflatten(state_tree, [visit(k, leaf) for k, leaf in pairs])


def spec_report(spec_tree: Any, shape_tree: Any) -> str:
    """Human-readable param-spec table (the reference's text)."""
    specs = tree_leaves(spec_tree, is_leaf=_is_spec)
    shapes = tree_leaves_with_path(shape_tree)
    return "\n".join(f"  {'/'.join(keys):60s} {str(tuple(leaf.shape)):28s} "
                     f"{spec}" for spec, (keys, leaf) in zip(specs, shapes))


# ---------------------------------------------------------------------------
# the serving mesh
# ---------------------------------------------------------------------------


class ServeMesh:
    """A 1-D ``("data",)`` mesh over ``devices`` (a device may repeat: on
    the CPU every shard shares the one CPU device)."""

    axis_names = ("data",)

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        if not devices:
            raise ValueError("a serving mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)

    @property
    def shape(self):
        return {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"ServeMesh(data={self.size}, devices={list(self.devices)})"


def serve_mesh(n_devices: Optional[int] = None,
               device_type: str = "cuda") -> ServeMesh:
    """1-D ``("data",)`` mesh over the local cards for the serving tier.

    ``n_devices`` defaults to every local card; without a card it raises.
    With ``device_type="cpu"`` the ``n_devices`` (default 1) shards share
    the one CPU device, so the split and the gather run there as they
    would across cards.  A 1-device mesh is valid and keeps the sharded
    path identical from one card to many.
    """
    if device_type == "cpu":
        return ServeMesh([torch.device("cpu")] * (n_devices or 1))
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}; use "
                         "'cuda' or 'cpu'")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' for a mesh on the CPU")
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"a mesh of {n} cards asked for; {count} present")
    return ServeMesh([torch.device("cuda", i) for i in range(n)])


def serve_batch_pspec(mesh: ServeMesh) -> Tuple[Optional[str]]:
    """The leading-axis batch split of serve batches on a ``serve_mesh``:
    ``("data",)`` splits it over the mesh's devices, ``(None,)``
    replicates it."""
    return ("data" if "data" in mesh.axis_names else None,)


def split_batch(x, n: int):
    """The split rule: ``n`` even slices of the leading (batch) axis of a
    tensor or a numpy array (views, in order)."""
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split evenly "
                         f"over {n} devices")
    return torch.chunk(x, n) if isinstance(x, torch.Tensor) else np.split(x, n)


def shard_serve_fn(fn: Union[Callable, Sequence[Callable]], mesh: ServeMesh):
    """Split a batched ``(B, ...) -> (B, ...)`` function over ``data``.

    ``fn`` is one function for every device, or one per mesh device (a
    step whose operands live on that device).  The wrapped function takes
    a tensor or a numpy array, splits its leading axis evenly (the
    micro-batcher aligns every bucket to the mesh, so the split is always
    even), runs each slice on its device, and gathers the outputs in order:
    on the input's device, or on the CPU for a numpy input.  Every shard
    is launched before any output is gathered, so the cards run side by
    side.  The per-shard bodies are independent (no collectives).
    """
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn] * mesh.size
    if len(fns) != mesh.size:
        raise ValueError(f"{len(fns)} functions for a mesh of {mesh.size}")
    split = serve_batch_pspec(mesh)[0] is not None

    def sharded(x):
        home = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
        shards = split_batch(x, mesh.size if split else 1)
        outs = []
        for f, dev, shard in zip(fns, mesh.devices, shards):
            # a card's kernels launch on its current stream
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                outs.append(f(torch.as_tensor(shard, device=dev)))
        return torch.cat([o.to(home) for o in outs])

    return sharded
