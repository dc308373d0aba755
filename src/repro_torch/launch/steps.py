"""Cell builder: (arch x shape x mesh) -> step function + shardings + specs.

Port of ``repro/launch/steps.py``, the one source of what each of the 40
grid cells runs: ``train_*`` shapes a full AdamW ``train_step`` (f32
master params and moments, bf16 compute, gradient accumulation, layers
recomputed in the backward), ``prefill_*`` the cache-building
``prefill_step``, and ``decode_*`` / ``long_*`` a one-token
``serve_step`` against a pre-allocated decode state.

A plan's ``args`` are meta tensors (the reference's ``ShapeDtypeStruct``):
nothing is allocated until a caller runs the step on real tensors through
:meth:`CellPlan.jitted` (the port of ``jax.jit``: a CUDA graph replayed on
fixed buffers on the card, the donated train / decode state rewritten in
place), and :mod:`repro_torch.launch.dryrun` counts a step on the meta
tensors themselves.  The shardings are the spec trees of
:mod:`repro_torch.distributed.sharding` on the cell's mesh; the port has no
SPMD partitioner, so a step runs whole on one device and the dry-run
reads the specs for per-device sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.registry import (SHAPES, ShapeSpec, cell_applicable,
                                          get_config)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                              PartitionSpec, act_pspec,
                                              decode_state_specs, logits_pspec,
                                              named_tree, partition_params,
                                              train_batch_spec)
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import (init_decode_state, init_lm, lm_decode_step,
                                   lm_loss, lm_prefill)
from repro_torch.models.whisper import (init_whisper, init_whisper_decode_state,
                                        whisper_decode_step, whisper_loss,
                                        whisper_prefill)
from repro_torch.train.capture import static_jit
from repro_torch.train.optimizer import adamw, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["CellPlan", "build_cell", "WHISPER_S_ENC"]

# Whisper's frontend stub length: ~40 s of audio at 50 frames/s (the
# assigned seq_len applies to the decoder token stream).
WHISPER_S_ENC = 2048


@dataclasses.dataclass
class CellPlan:
    arch_id: str
    shape: ShapeSpec
    cfg: ArchConfig
    kind: str                       # train | prefill | decode
    fn: Callable                    # the step on tensor trees
    args: Tuple[Any, ...]           # meta-tensor trees, positional
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    act_sharding: Any
    logits_sharding: Any
    mesh: Mesh
    head_sharding: Any = None

    def jitted(self, device=None, *, capture: Optional[bool] = None):
        """The step on real tensors on ``device`` (the card unless
        ``"cpu"``): on the card each call replays a CUDA graph on fixed
        buffers (captured at its first call; ``capture=False`` runs the
        same buffers op by op, as the CPU always does), and a donated
        argument comes back as the buffers it was copied into, rewritten
        in place (see :func:`repro_torch.train.capture.static_jit`)."""
        return static_jit(self.fn, resolve_device(device),
                          donate_argnums=self.donate_argnums, capture=capture)


def _meta(tree):
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), tree)


def _param_shapes(cfg: ArchConfig, dtype) -> Any:
    """The params tree as meta tensors: the initialiser runs under a fake
    tensor mode (it allocates nothing), as ``jax.eval_shape`` runs it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        if cfg.family == "encdec":
            params = init_whisper(torch.Generator(), cfg, dtype=dtype)
        else:
            params = init_lm(torch.Generator(), cfg, dtype=dtype)
    return _meta(params)


def _batch_shapes(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device="meta"),
    }
    if shape.kind == "train":
        batch["labels"] = torch.empty((b, s), dtype=torch.int32, device="meta")
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.empty((b, cfg.n_patches, cfg.d_model),
                                            dtype=torch.bfloat16, device="meta")
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((b, WHISPER_S_ENC, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    return batch


def _batch_specs(batch: Dict[str, Any], mesh: Mesh, b: int
                 ) -> Dict[str, PartitionSpec]:
    return {k: train_batch_spec(mesh, b, rank=len(v.shape))
            for k, v in batch.items()}


def _loss_fn(cfg: ArchConfig):
    """Full recomputation everywhere (the reference's ``_remat_policy`` is
    ``None``): the layer bodies run under ``models.lm.remat``."""
    def loss(params, batch):
        if cfg.family == "encdec":
            return whisper_loss(params, batch["frames"], batch["tokens"],
                                batch["labels"], cfg)
        return lm_loss(params, batch["tokens"], batch["labels"], cfg,
                       patch_embeds=batch.get("patch_embeds"))
    return loss


def _to_bf16(tree):
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if x.dtype == torch.float32 else x, tree)


# ---------------------------------------------------------------------------
# cell kinds
# ---------------------------------------------------------------------------

def _grad_accum_steps(cfg: ArchConfig, batch: int) -> int:
    """Microbatch count for the big train cells: the same global batch,
    1/n the live activations per pass (MoE archs size by active params)."""
    n_params = cfg.param_count(active_only=(cfg.family == "moe"))
    total = cfg.param_count()
    n = 4 if total > 5e10 else (2 if n_params > 8e9 else 1)
    while batch % n:
        n //= 2
    return max(1, n)


def _value_and_grad(loss_fn, params, batch):
    """``jax.value_and_grad(lambda p: loss_fn(bf16(p), batch))(params)``:
    the loss and f32 gradients of the f32 master params."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(_to_bf16(tree_unflatten(params, leaves)), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])


def _train_cell(arch_id: str, shape: ShapeSpec, cfg: ArchConfig,
                mesh: Mesh) -> CellPlan:
    params = _param_shapes(cfg, torch.float32)
    opt_init, opt_update = adamw(3e-4, weight_decay=0.1)
    state = {"params": params, "opt": opt_init(params)}
    batch = _batch_shapes(cfg, shape)
    n_micro = _grad_accum_steps(cfg, shape.global_batch)
    loss_fn = _loss_fn(cfg)
    state_specs = partition_params(state, mesh, n_experts=cfg.padded_experts,
                                   head_dim=cfg.hd)

    def train_step(state, batch):
        params = state["params"]
        if n_micro == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(n_micro):
                l, g = _value_and_grad(loss_fn, params,
                                       {k: v[i] for k, v in micro.items()})
                loss = loss + l
                grads = tree_map(lambda a, x: a + x.to(torch.float32), grads, g)
            loss = loss / n_micro
            grads = tree_map(lambda g: g / n_micro, grads)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, 1.0)
            updates, opt = opt_update(grads, state["opt"], params)
            new_params = apply_updates(params, updates)
        return {"params": new_params, "opt": opt}, {"loss": loss, "gnorm": gnorm}

    batch_specs = _batch_specs(batch, mesh, shape.global_batch)
    metrics_specs = {"loss": PartitionSpec(), "gnorm": PartitionSpec()}
    return CellPlan(
        arch_id=arch_id, shape=shape, cfg=cfg, kind="train",
        fn=train_step,
        args=(state, batch),
        in_shardings=(named_tree(state_specs, mesh),
                      named_tree(batch_specs, mesh)),
        out_shardings=(named_tree(state_specs, mesh),
                       named_tree(metrics_specs, mesh)),
        donate_argnums=(0,),
        act_sharding=NamedSharding(
            mesh, act_pspec(mesh, shape.global_batch, shape.seq_len)),
        logits_sharding=NamedSharding(
            mesh, logits_pspec(mesh, shape.global_batch, shape.seq_len,
                               cfg.padded_vocab)),
        head_sharding=NamedSharding(
            mesh, train_batch_spec(mesh, shape.global_batch, rank=3)),
        mesh=mesh,
    )


def _prefill_cell(arch_id: str, shape: ShapeSpec, cfg: ArchConfig,
                  mesh: Mesh) -> CellPlan:
    params = _param_shapes(cfg, torch.bfloat16)
    batch = _batch_shapes(cfg, shape)

    if cfg.family == "encdec":
        def prefill_step(params, batch):
            return whisper_prefill(params, batch["frames"], batch["tokens"], cfg)
    else:
        def prefill_step(params, batch):
            return lm_prefill(params, batch["tokens"], cfg,
                              patch_embeds=batch.get("patch_embeds"))

    param_specs = partition_params(params, mesh, n_experts=cfg.padded_experts,
                                   head_dim=cfg.hd)
    batch_specs = _batch_specs(batch, mesh, shape.global_batch)
    with torch.no_grad():               # the output shapes (eval_shape)
        _, state_sd = prefill_step(params, batch)
    state_specs = decode_state_specs(state_sd, mesh, shape.global_batch)
    out_logits_spec = logits_pspec(mesh, shape.global_batch, 1,
                                   cfg.padded_vocab)
    return CellPlan(
        arch_id=arch_id, shape=shape, cfg=cfg, kind="prefill",
        fn=prefill_step,
        args=(params, batch),
        in_shardings=(named_tree(param_specs, mesh),
                      named_tree(batch_specs, mesh)),
        out_shardings=(NamedSharding(mesh, out_logits_spec),
                       named_tree(state_specs, mesh)),
        donate_argnums=(),
        act_sharding=NamedSharding(
            mesh, act_pspec(mesh, shape.global_batch, shape.seq_len)),
        logits_sharding=None,
        head_sharding=NamedSharding(
            mesh, train_batch_spec(mesh, shape.global_batch, rank=3)),
        mesh=mesh,
    )


def _decode_cell(arch_id: str, shape: ShapeSpec, cfg: ArchConfig, mesh: Mesh,
                 kv_int8: bool = False) -> CellPlan:
    b, ctx = shape.global_batch, shape.seq_len
    params = _param_shapes(cfg, torch.bfloat16)
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")

    if cfg.family == "encdec":
        state = init_whisper_decode_state(cfg, b, ctx, WHISPER_S_ENC,
                                          device="meta")

        def serve_step(params, state, token):
            return whisper_decode_step(params, state, token, cfg)
    else:
        state = init_decode_state(cfg, b, ctx, kv_int8=kv_int8, device="meta")

        def serve_step(params, state, token):
            return lm_decode_step(params, state, token, cfg)

    param_specs = partition_params(params, mesh, n_experts=cfg.padded_experts,
                                   head_dim=cfg.hd)
    state_specs = decode_state_specs(state, mesh, b)
    out_logits_spec = logits_pspec(mesh, b, 1, cfg.padded_vocab)
    return CellPlan(
        arch_id=arch_id, shape=shape, cfg=cfg, kind="decode",
        fn=serve_step,
        args=(params, state, token),
        in_shardings=(named_tree(param_specs, mesh),
                      named_tree(state_specs, mesh),
                      NamedSharding(mesh, train_batch_spec(mesh, b))),
        out_shardings=(NamedSharding(mesh, out_logits_spec),
                       named_tree(state_specs, mesh)),
        donate_argnums=(1,),
        act_sharding=NamedSharding(mesh, act_pspec(mesh, b, 1)),
        logits_sharding=NamedSharding(mesh, logits_pspec(mesh, b, 1,
                                                         cfg.padded_vocab)),
        head_sharding=NamedSharding(mesh, train_batch_spec(mesh, b, rank=3)),
        mesh=mesh,
    )


def build_cell(arch_id: str, shape_name: str, mesh: Mesh,
               kv_int8: bool = False) -> CellPlan:
    ok, why = cell_applicable(arch_id, shape_name)
    if not ok:
        raise ValueError(f"cell skipped by design: {why}")
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return _train_cell(arch_id, shape, cfg, mesh)
    if shape.kind == "prefill":
        return _prefill_cell(arch_id, shape, cfg, mesh)
    return _decode_cell(arch_id, shape, cfg, mesh, kv_int8=kv_int8)
