"""Surrogate-gradient BPTT trainer for the SNN AMC classifier.

Port of ``repro/train/trainer.py``, the paper's training recipe:

* BPTT through T timesteps with the fast-sigmoid surrogate spike gradient,
  on the differentiable ``dense`` backend (``SNNProgram._bind``), the
  whole batch at once (the reference ``vmap``s one sample at a time: the
  same math, summed in another order);
* joint **pruning** (L1 unstructured, 20/60/20 three-phase schedule,
  per-layer target densities): masks recomputed on a fixed cadence during
  the pruning phase, frozen for fine-tuning, and the gradients of pruned
  weights zeroed before clipping;
* joint **LSQ** quantization-aware training (trainable step sizes, stepped
  as ``s - 1e-4 * g``);
* AdamW with global-norm clipping (:mod:`repro_torch.train.optimizer`,
  the reference's arithmetic);
* fault tolerance: atomic keep-N checkpoints of params, optimizer state,
  masks and LSQ scales in the reference's on-disk format, deterministic
  resume, and a step-time straggler monitor.

Each step generates its batch on the host (numpy RadioML, then the numpy
Σ-Δ encoder) and copies it to the device once.  The trainer runs on the
card unless ``device="cpu"`` is passed.  It expects float32 products: keep
``torch.backends.cuda.matmul.allow_tf32`` off (PyTorch's default).

Weights start from the port's numpy-seeded :func:`init_snn`, so they
differ from the reference's jax-keyed ones; to train from the reference's
weights, set ``params`` and rebuild ``opt_state = opt_init(params)`` and
``lsq_scales = init_lsq_scales(params, bits)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import sigma_delta_encode_np
from repro_torch.data.radioml import N_CLASSES, generate_batch
from repro_torch.device import resolve_device
from repro_torch.models.graph import compile_snn
from repro_torch.models.snn import SNNConfig, init_snn
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from .checkpoint import CheckpointManager
from .lsq import init_lsq_scales, lsq_fake_quant
from .optimizer import adamw, apply_updates, clip_by_global_norm
from .pruning import make_mask_pytree, target_density_at

__all__ = ["TrainerConfig", "SNNTrainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 300
    batch_size: int = 64
    lr: float = 2e-3
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    osr: int = 8
    seed: int = 0
    snr_db: Optional[float] = 10.0     # train at high SNR by default
    # pruning (None -> dense training)
    final_density: Optional[float] = None      # scalar or use per_layer below
    per_layer_density: Optional[Dict[str, float]] = None
    prune_every: int = 20
    # quantization
    use_lsq: bool = False
    quant_bits: int = 16
    # channel-scenario augmentation: waits for the channel scenarios
    augment_scenario: Optional[Any] = None
    # fault tolerance
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep_ckpts: int = 3
    # straggler monitor
    straggler_factor: float = 3.0


def _loss_fn(params, lsq_scales, frames, labels, cfg: SNNConfig, masks,
             use_lsq: bool, bits: int, device):
    """(NLL of log_softmax, accuracy) over the batch, on the dense path."""
    quant_fn = None
    if use_lsq:
        # per-layer scales threaded by index through the bind's quant_fn,
        # which it calls once per weighted layer in graph order
        idx = {"i": 0}
        flat_scales = lsq_scales["conv"] + lsq_scales["fc"]

        def quant_fn(w):
            s = flat_scales[idx["i"]]
            idx["i"] += 1
            return lsq_fake_quant(w, s, bits)

    bound = compile_snn(cfg)._bind(params, "dense", masks=masks,
                                   quant_fn=quant_fn, device=device)
    logits = bound.batch(frames)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return nll, acc


def _requiring_grad(tree):
    return tree_map(lambda x: x.detach().requires_grad_(), tree)


class SNNTrainer:
    def __init__(self, model_cfg: SNNConfig, cfg: TrainerConfig, device=None):
        if cfg.augment_scenario is not None:
            raise NotImplementedError(
                "augment_scenario needs the channel scenarios, which are not "
                "ported yet (ROADMAP Queue 1, the channel step)")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda x: x.to(self.device),
                               init_snn(cfg.seed, model_cfg))
        self.opt_init, self.opt_update = adamw(cfg.lr,
                                               weight_decay=cfg.weight_decay)
        self.opt_state = self.opt_init(self.params)
        self.lsq_scales = (init_lsq_scales(self.params, cfg.quant_bits)
                           if cfg.use_lsq else None)
        self.masks = None
        self.step = 0
        self.step_times: List[float] = []
        self.stragglers: List[int] = []
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
                     if cfg.ckpt_dir else None)
        # reduced configs classify a class subset: labels outside
        # [0, n_classes) would make the NLL meaningless
        self._classes = (tuple(range(model_cfg.n_classes))
                         if model_cfg.n_classes < N_CLASSES else None)

    # -- data ---------------------------------------------------------------

    def _batch(self, seed: int, snr_db: Optional[float]):
        """One host batch, encoded, then copied to the device once:
        ``(frames (B, T, 2, L), labels (B,) int64 on the device, labels as
        numpy)``."""
        iq, labels, _ = generate_batch(
            seed, self.cfg.batch_size, snr_db,
            frame_len=self.model_cfg.input_width, classes=self._classes)
        frames = sigma_delta_encode_np(iq, self.cfg.osr)
        return (torch.from_numpy(frames).to(self.device),
                torch.from_numpy(labels.astype(np.int64)).to(self.device),
                labels)

    # -- core step ----------------------------------------------------------

    def _gradients(self, params, lsq_scales, masks, frames, labels):
        """``(loss, acc, clipped param grads, LSQ scale grads, grad norm)``.

        The gradients of pruned weights are zeroed before the clip; a leaf
        the loss does not reach (the last layer's LIF under the
        ``current_sum`` readout) gets a zero gradient, as under jax."""
        use_lsq = self.cfg.use_lsq
        p = _requiring_grad(params)
        s = _requiring_grad(lsq_scales) if use_lsq else None
        loss, acc = _loss_fn(p, s, frames, labels, self.model_cfg, masks,
                             use_lsq, self.cfg.quant_bits, self.device)
        p_leaves = tree_leaves(p)
        loss.backward()
        grads = [torch.zeros_like(x) if x.grad is None else x.grad
                 for x in p_leaves + tree_leaves(s)]
        n = len(p_leaves)
        g_params = tree_unflatten(params, grads[:n])
        g_scales = tree_unflatten(lsq_scales, grads[n:]) if use_lsq else None
        with torch.no_grad():
            if masks is not None:
                for group in ("conv", "fc"):
                    for g, m in zip(g_params[group], masks[group]):
                        g["w"] = g["w"] * m
            g_params, gnorm = clip_by_global_norm(g_params, self.cfg.clip_norm)
        return loss.detach(), acc, g_params, g_scales, gnorm

    def _train_step(self, params, opt_state, lsq_scales, masks, frames, labels):
        loss, acc, g_params, g_scales, gnorm = self._gradients(
            params, lsq_scales, masks, frames, labels)
        with torch.no_grad():
            updates, opt_state = self.opt_update(g_params, opt_state, params)
            params = apply_updates(params, updates)
            if self.cfg.use_lsq:
                lsq_scales = tree_map(lambda s, g: s - 1e-4 * g, lsq_scales,
                                      g_scales)
        return params, opt_state, lsq_scales, loss, acc, gnorm

    # -- pruning schedule ---------------------------------------------------

    def _density_target(self) -> Optional[Any]:
        if self.cfg.per_layer_density is not None:
            # scale each layer's final density along the shared ramp
            ramp = target_density_at(self.step, self.cfg.total_steps, 0.0)
            # ramp in [0,1] where 1 = dense; interpolate toward each target
            return {
                k: 1.0 - (1.0 - v) * (1.0 - ramp)
                for k, v in self.cfg.per_layer_density.items()
            }
        if self.cfg.final_density is not None:
            return target_density_at(self.step, self.cfg.total_steps,
                                     self.cfg.final_density)
        return None

    def _maybe_reprune(self):
        target = self._density_target()
        if target is None:
            return
        in_prune_phase = self.step < 0.8 * self.cfg.total_steps
        if self.masks is None or (in_prune_phase
                                  and self.step % self.cfg.prune_every == 0):
            self.masks = make_mask_pytree(self.params, target)

    # -- fault tolerance ------------------------------------------------------

    def _state_tree(self):
        return {
            "params": self.params,
            "opt": self.opt_state,
            "masks": self.masks,
            "lsq": self.lsq_scales,
        }

    def save(self):
        if self.ckpt:
            self.ckpt.save(self.step, self._state_tree(),
                           extra={"step": self.step})

    def resume(self, step: Optional[int] = None) -> bool:
        """Restore training state from ``step`` (default: the latest)."""
        if not self.ckpt or self.ckpt.latest_step() is None:
            return False
        # the like-tree needs masks allocated when the config prunes
        if (self.cfg.final_density or self.cfg.per_layer_density) \
                and self.masks is None:
            self.masks = make_mask_pytree(self.params, 1.0)
        tree, manifest = self.ckpt.restore(self._state_tree(), step=step,
                                           device=self.device)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.masks = tree["masks"]
        self.lsq_scales = tree["lsq"]
        self.step = int(manifest["extra"]["step"])
        return True

    # -- loop -----------------------------------------------------------------

    def run(self, steps: Optional[int] = None,
            log_every: int = 50) -> Dict[str, List[float]]:
        steps = steps if steps is not None else self.cfg.total_steps
        history: Dict[str, List[float]] = {"loss": [], "acc": [], "step": []}
        end = self.step + steps
        while self.step < end:
            t0 = time.perf_counter()
            self._maybe_reprune()
            frames, labels, _ = self._batch(
                self.cfg.seed * 7_919 + self.step, self.cfg.snr_db)
            (self.params, self.opt_state, self.lsq_scales, loss, acc,
             _) = self._train_step(self.params, self.opt_state,
                                   self.lsq_scales, self.masks, frames, labels)
            self.step += 1
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            # straggler detection: flag steps >> trailing median
            if len(self.step_times) >= 10:
                med = float(np.median(self.step_times[-50:]))
                if dt > self.cfg.straggler_factor * med:
                    self.stragglers.append(self.step)
            if self.step % log_every == 0 or self.step == end:
                history["loss"].append(float(loss))
                history["acc"].append(float(acc))
                history["step"].append(self.step)
            if self.ckpt and self.step % self.cfg.ckpt_every == 0:
                self.save()
        if self.ckpt:
            self.save()
            self.ckpt.wait()
        return history

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, n_batches: int = 4, snr_db: Optional[float] = None,
                 seed: int = 10_000, scenario=None) -> float:
        """Accuracy over fresh batches (``dense`` through ``apply_batch``)."""
        if scenario is not None:
            raise NotImplementedError(
                "scenario evaluation needs the channel scenarios, which are "
                "not ported yet (ROADMAP Queue 1, the channel step)")
        program = compile_snn(self.model_cfg)
        correct, total = 0, 0
        for b in range(n_batches):
            frames, _, labels = self._batch(seed + b, snr_db)
            with torch.no_grad():
                logits = program.apply_batch(self.params, frames, "dense",
                                             masks=self.masks,
                                             device=self.device)
            correct += int((logits.argmax(-1).cpu().numpy() == labels).sum())
            total += len(labels)
        return correct / total
