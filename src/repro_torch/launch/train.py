"""Training entry point: ``python -m repro_torch.launch.train --arch <id>``.

Port of ``repro/launch/train.py``; runs on the card (``--device cpu`` for
the CPU).  Two modes:

* ``--arch saocds-amc`` — the paper's SNN classifier end to end: Σ-Δ
  encoded synthetic RadioML, surrogate-gradient BPTT, optional pruning
  (``--density``) and 16-bit LSQ (``--lsq``).  On the card each step
  replays the trainer's CUDA graph without waiting for it.
* ``--arch <assigned-lm-id>`` — any of the 10 assigned architectures at
  its ``--scale reduced`` or ``--scale full`` config (:class:`LMTrainer`),
  on the synthetic Zipf token stream, with AdamW + clipping.  On the card
  each step replays the trainer's CUDA graph too.

Both checkpoint every ``--ckpt-every`` steps (atomic, keep-N, the
reference's on-disk format), resume with ``--resume``, and flag steps
above 3x the trailing median as stragglers.  The median step time printed
is the host's, step to step.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.data.pipeline import lm_token_batches
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import init_lm, lm_loss
from repro_torch.models.whisper import init_whisper, whisper_loss
from repro_torch.train.capture import static_jit
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import adamw, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["LMTrainer", "main"]


class LMTrainer:
    """Synthetic-stream LM trainer for the assigned architectures, on
    ``device`` (the card unless ``"cpu"``).

    The params are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)``, so one seed gives the same params on every device.  Each step
    is the reference's: the loss and its gradients (``torch.autograd``),
    ``clip_by_global_norm(1.0)``, AdamW with ``weight_decay=0.01``.

    The step is the port of the reference's ``jax.jit(train_step)``
    (:func:`repro_torch.train.capture.static_jit`, the state donated): on
    the card it replays one CUDA graph per batch shape (``capture=False``
    runs the same buffers op by op, as the CPU always does).  ``params``
    and ``opt_state`` are the step's state buffers after the first step,
    rewritten in place by every later step (clone them to keep a copy);
    assigning either (for example the reference's params through
    :func:`repro_torch.convert.lm_params_from_numpy`, with ``opt_state =
    opt_init(params)``) changes what the next step starts from.
    """

    def __init__(self, cfg: ArchConfig, *, lr: float = 3e-4, seed: int = 0,
                 batch: int = 8, seq: int = 64,
                 ckpt_dir: Optional[str] = None, keep: int = 3, device=None,
                 capture: Optional[bool] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch, self.seq = batch, seq
        gen = torch.Generator().manual_seed(seed)
        if cfg.family == "encdec":
            params = init_whisper(gen, cfg, max_dec_pos=max(seq, 128),
                                  device=self.device)
        else:
            params = init_lm(gen, cfg, device=self.device)
        self.opt_init, self.opt_update = adamw(lr, weight_decay=0.01)
        self.state = {"params": params, "opt": self.opt_init(params)}
        self._step = static_jit(self._train_step, self.device,
                                donate_argnums=(0,), capture=capture)
        self.step = 0
        self.step_times: list = []
        self.stragglers: list = []
        self.ckpt = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None

    @property
    def params(self):
        return self.state["params"]

    @params.setter
    def params(self, tree):
        self.state = {**self.state, "params": tree}

    @property
    def opt_state(self):
        return self.state["opt"]

    @opt_state.setter
    def opt_state(self, tree):
        self.state = {**self.state, "opt": tree}

    def loss(self, params, tokens, labels, extra) -> torch.Tensor:
        if self.cfg.family == "encdec":
            return whisper_loss(params, extra, tokens, labels, self.cfg)
        return lm_loss(params, tokens, labels, self.cfg, patch_embeds=extra)

    def _train_step(self, state, batch):
        """The pure step: (state, batch) -> (new state, (loss, gnorm))."""
        params = state["params"]
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = self.loss(tree_unflatten(params, leaves), batch["tokens"],
                         batch["labels"], batch.get("extra"))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, 1.0)
            updates, opt = self.opt_update(grads, state["opt"], params)
            new_params = apply_updates(params, updates)
        return {"params": new_params, "opt": opt}, (loss.detach(), gnorm)

    def train_step(self, tokens, labels, extra):
        """One step from ``self.params`` / ``self.opt_state`` on a batch
        (numpy arrays or tensors); returns the loss and the gradients'
        global norm before clipping."""
        batch = {"tokens": tokens, "labels": labels}
        if extra is not None:
            batch["extra"] = extra
        self.state, (loss, gnorm) = self._step(self.state, batch)
        return loss, gnorm

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the trainer's device.  To the card it goes from
        pinned memory without a wait: a copy from pageable memory would
        synchronise the host with the card at every step."""
        t = torch.from_numpy(x)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def extra(self, rng: np.random.Generator):
        """The step's stub frontend input, drawn as the reference draws it:
        VLM patch embeddings (bf16), whisper frame embeddings (f32)."""
        if self.cfg.family == "vlm":
            x = rng.normal(size=(self.batch, self.cfg.n_patches,
                                 self.cfg.d_model)).astype(np.float32) * 0.02
            return self._to_device(x).to(torch.bfloat16)
        if self.cfg.family == "encdec":
            x = rng.normal(size=(self.batch, self.seq, self.cfg.d_model)
                           ).astype(np.float32) * 0.02
            return self._to_device(x)
        return None

    def run(self, steps: int, log_every: int = 20,
            ckpt_every: int = 0) -> dict:
        history = {"step": [], "loss": []}
        gen = lm_token_batches(self.batch, self.seq, self.cfg.vocab,
                               seed=self.step + 1)
        rng = np.random.default_rng(17 + self.step)
        end = self.step + steps
        while self.step < end:
            t0 = time.perf_counter()
            tokens, labels = next(gen)
            loss, gnorm = self.train_step(tokens, labels, self.extra(rng))
            self.step += 1
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            if len(self.step_times) >= 10:
                med = float(np.median(self.step_times[-50:]))
                if dt > 3.0 * med:
                    self.stragglers.append(self.step)
            if self.step % log_every == 0 or self.step == end:
                history["step"].append(self.step)
                history["loss"].append(float(loss))
                print(f"step {self.step:5d} loss {float(loss):.4f} "
                      f"gnorm {float(gnorm):.3f} {dt * 1e3:.0f} ms")
            if self.ckpt and ckpt_every and self.step % ckpt_every == 0:
                self.save()
        if self.ckpt:
            self.save()
            self.ckpt.wait()
        return history

    # -- fault tolerance ----------------------------------------------------

    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self):
        if self.ckpt:
            self.ckpt.save(self.step, self._state_tree(),
                           extra={"step": self.step})

    def resume(self) -> bool:
        if not self.ckpt or self.ckpt.latest_step() is None:
            return False
        tree, manifest = self.ckpt.restore(self._state_tree())
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.step = int(manifest["extra"]["step"])
        return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True,
                    choices=list(ARCH_IDS) + ["saocds-amc"])
    ap.add_argument("--scale", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--density", type=float, default=None,
                    help="saocds-amc: target weight density (pruning)")
    ap.add_argument("--lsq", action="store_true",
                    help="saocds-amc: 16-bit LSQ quantization-aware training")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)

    if args.arch == "saocds-amc":
        from repro_torch.configs.saocds_amc import CONFIG
        from repro_torch.train.trainer import SNNTrainer, TrainerConfig

        tcfg = TrainerConfig(
            total_steps=args.steps, batch_size=args.batch, lr=args.lr,
            final_density=args.density, use_lsq=args.lsq,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        )
        trainer = SNNTrainer(CONFIG, tcfg, device=args.device)
        if args.resume and trainer.resume():
            print(f"resumed at step {trainer.step}")
        hist = trainer.run()
        acc = trainer.evaluate(snr_db=10.0)
        step_ms = statistics.median(trainer.step_times) * 1e3
        print(f"final loss {hist['loss'][-1]:.4f}  acc@10dB {acc:.3f}  "
              f"step {step_ms:.3f} ms (median, host to host)  "
              f"stragglers {len(trainer.stragglers)}")
        return 0

    cfg = get_config(args.arch) if args.scale == "full" else reduced_config(args.arch)
    trainer = LMTrainer(cfg, lr=args.lr, batch=args.batch, seq=args.seq,
                        ckpt_dir=args.ckpt_dir, device=args.device)
    if args.resume and trainer.resume():
        print(f"resumed at step {trainer.step}")
    hist = trainer.run(args.steps, ckpt_every=args.ckpt_every)
    step_ms = statistics.median(trainer.step_times) * 1e3
    print(f"final loss {hist['loss'][-1]:.4f}  step {step_ms:.3f} ms "
          f"(median, host to host)  stragglers {len(trainer.stragglers)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
