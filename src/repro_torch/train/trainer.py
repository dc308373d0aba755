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
Σ-Δ encoder) and copies it to the device once; with ``augment_scenario``
the clean frames first run through that channel scenario on the device.
The trainer runs on the card unless ``device="cpu"`` is passed.  It
expects float32 products: keep ``torch.backends.cuda.matmul.allow_tf32``
off (PyTorch's default) and ``torch.backends.cudnn.allow_tf32`` off too
(it defaults to on; no step of the trainer calls cuDNN).

On the card the step is captured in CUDA graphs (:mod:`repro_torch.train.
capture`, the port of the reference's ``jax.jit``): one graph per
``(use_masks, batch shape)`` holds the forward, the BPTT backward, the
mask product on the gradients, the clip, AdamW and the LSQ step, and
:meth:`SNNTrainer.run` replays it without waiting for the card, reading
the loss only on a logging step, so the host generates the next batch
while the card runs the step.  :meth:`SNNTrainer.evaluate` replays one
graph per batch shape and masks variant.  ``capture=False`` runs the same
steps op by op (what a replay is held to); on the CPU they always run so.
A step that fails to capture raises; it never runs eagerly instead.

The state contract: ``params``, ``opt_state``, ``lsq_scales`` and
``masks`` live in fixed buffers that the graphs read and write.  A tree
read from one of those attributes is a copy, made at the first read after
a step, so later steps never change it; a tree assigned to one of them is
copied into the buffers before the next step, so assigning (``resume``,
a reprune, the reference's weights) needs no new capture.
:meth:`SNNTrainer._gradients` and :meth:`SNNTrainer._train_step` stay
pure functions of the trees they are given.

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

from repro_torch.channel.scenario import apply_scenario_np
from repro_torch.data.pipeline import sigma_delta_encode_np
from repro_torch.data.radioml import N_CLASSES, generate_batch
from repro_torch.device import resolve_device
from repro_torch.models.graph import compile_snn
from repro_torch.models.snn import SNNConfig, init_snn
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from .capture import StaticStep, TrainState
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
    # channel-scenario augmentation: a repro_torch.channel scenario name or
    # ChannelScenario; batches are generated clean, then run through it
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
    """The paper's trainer on ``device`` (the card unless ``"cpu"``).

    ``capture`` (default: on a CUDA device) runs :meth:`run`'s steps and
    :meth:`evaluate`'s forwards by CUDA-graph replay; ``False`` runs them
    op by op on the same buffers.  Reading ``params``, ``opt_state``,
    ``lsq_scales`` or ``masks`` gives a copy that later steps leave alone;
    assigning one takes effect at the next step (the module docstring).
    """

    def __init__(self, model_cfg: SNNConfig, cfg: TrainerConfig, device=None,
                 capture: Optional[bool] = None):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.capture = (self.device.type == "cuda" if capture is None
                        else capture)
        self._state = TrainState(self.device)
        # BPTT warms up a few times before its capture, as torch's
        # whole-network recipe does; the forward once
        self._steps = StaticStep(self.device, self.capture, warmups=3)
        self._evals = StaticStep(self.device, self.capture, warmups=1)
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

    # -- state (fixed buffers behind copies; see the module docstring) -------

    @property
    def params(self):
        return self._state.get("params")

    @params.setter
    def params(self, tree) -> None:
        self._state.set("params", tree)

    @property
    def opt_state(self):
        return self._state.get("opt")

    @opt_state.setter
    def opt_state(self, tree) -> None:
        self._state.set("opt", tree)

    @property
    def lsq_scales(self):
        return self._state.get("lsq")

    @lsq_scales.setter
    def lsq_scales(self, tree) -> None:
        self._state.set("lsq", tree)

    @property
    def masks(self):
        return self._state.get("masks")

    @masks.setter
    def masks(self, tree) -> None:
        self._state.set("masks", tree)

    # -- data ---------------------------------------------------------------

    def _host_batch(self, seed: int, snr_db: Optional[float], scenario=None):
        """One batch on the host: ``(frames (B, T, 2, L) float32, labels
        (B,) int64)``, encoded.  With a ``scenario`` the frames are
        generated clean and run through its channel (on the trainer's
        device, drawn from ``seed``) instead of the legacy dataset
        channel."""
        iq, labels, snrs = generate_batch(
            seed, self.cfg.batch_size, snr_db,
            frame_len=self.model_cfg.input_width, classes=self._classes,
            apply_channel=scenario is None)
        if scenario is not None:
            iq = apply_scenario_np(scenario, iq, snrs, seed,
                                   device=self.device)
        return sigma_delta_encode_np(iq, self.cfg.osr), labels.astype(np.int64)

    def _batch(self, seed: int, snr_db: Optional[float], scenario=None):
        """:meth:`_host_batch` copied to the device once: ``(frames,
        labels on the device, labels as numpy)``."""
        frames, labels = self._host_batch(seed, snr_db, scenario)
        return (torch.from_numpy(frames).to(self.device),
                torch.from_numpy(labels).to(self.device), labels)

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
        leaves = p_leaves + tree_leaves(s)
        # returned, not accumulated into .grad: a replayed graph must not
        # add to an earlier replay's gradients
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
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

    def _step_on_buffers(self, frames: np.ndarray, labels: np.ndarray):
        """One :meth:`_train_step` on the state buffers, the new state
        written back into them: by graph replay with ``capture`` (one graph
        per ``(use_masks, batch shape)``, the jit's static argument and
        retrace), else op by op.  Returns ``(loss, acc, gnorm)`` on the
        device, not waited for."""
        bufs = self._state.buffers()
        use_masks = bufs["masks"] is not None and self.masks is not None

        def fn(inp, commit: bool):
            new = self._train_step(bufs["params"], bufs["opt"], bufs["lsq"],
                                   bufs["masks"] if use_masks else None,
                                   inp["frames"], inp["labels"])
            if commit:
                with torch.no_grad():
                    for name, tree in zip(("params", "opt", "lsq"), new[:3]):
                        for dst, src in zip(tree_leaves(bufs[name]),
                                            tree_leaves(tree)):
                            dst.copy_(src)
            return new[3:]

        out = self._steps((use_masks, frames.shape),
                          {"frames": frames, "labels": labels}, fn)
        self._state.written(("params", "opt", "lsq"))
        return out

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
            frames, labels = self._host_batch(
                self.cfg.seed * 7_919 + self.step, self.cfg.snr_db,
                self.cfg.augment_scenario)
            loss, acc, _ = self._step_on_buffers(frames, labels)
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
        """Accuracy over fresh batches (the masked ``dense`` forward);
        ``scenario`` evaluates under an injected :mod:`repro_torch.channel`
        condition instead of the legacy dataset channel."""
        correct, total = 0, 0
        for b in range(n_batches):
            frames, labels = self._host_batch(seed + b, snr_db, scenario)
            logits = self._eval_logits(frames, self.masks is not None)
            correct += int((logits.argmax(-1) == labels).sum())
            total += len(labels)
        return correct / total

    def _eval_logits(self, frames: np.ndarray, use_masks: bool) -> np.ndarray:
        """Logits of ``frames`` (B, T, 2, L) on the host: the ``dense``
        bind of the state buffers (what ``apply_batch(..., "dense")``
        computes, without its plan's host-side hashing), by graph replay
        with ``capture`` (one graph per batch shape and masks variant)."""
        bufs = self._state.buffers()
        program = compile_snn(self.model_cfg)

        def fn(inp, commit: bool):
            with torch.no_grad():
                return program._bind(
                    bufs["params"], "dense",
                    masks=bufs["masks"] if use_masks else None,
                    device=self.device).batch(inp["frames"])

        return self._evals((use_masks, frames.shape), {"frames": frames},
                           fn).cpu().numpy()
