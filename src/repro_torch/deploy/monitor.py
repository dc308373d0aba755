"""Canary monitor: sliding-window shadow evaluation, auto-promote/rollback.

Port of ``repro/deploy/monitor.py``.  The shadow evaluation runs each
version's own serving step (:meth:`BoundVersion.step`) on the engine's
device; the default frame source is the port's RadioML generator.

A canary that *serves* traffic tells you its latency; it does not tell
you whether its classifications got worse at -8 dB.  The monitor closes
that loop the way the paper's edge node would: it **shadow-evaluates**
both the production baseline and the canary on synthetic
:mod:`repro_torch.data.radioml` frames, bucketed per SNR (the paper's Fig. 8
protocol — AMC accuracy is an SNR-conditional quantity, and a regression
confined to the low-SNR bins must not be averaged away), keeps a sliding
window of the last few evaluation rounds, and decides:

* **rollback** — any SNR bucket's windowed canary score drops more than
  ``acc_drop_tol`` below the baseline's, or the canary's served p99
  exceeds ``p99_factor`` x the baseline's: the canary is removed from the
  serving table and the router cleared, production keeps all traffic;
* **promote** — the canary stays within tolerance for ``promote_after``
  consecutive clean rounds: it becomes the engine's primary (via the
  same atomic flip a hot-swap uses) and, when a registry is attached,
  the ``production`` alias advances to it;
* **pending** — not enough evidence yet; keep watching.

Scoring modes:

* ``score="labels"`` — accuracy against the synthetic generator's ground
  truth (available here because the RadioML generator is part of the
  repo; in the field this is a labeled replay buffer);
* ``score="agreement"`` — fraction of frames where the canary's argmax
  matches *production's* (no ground truth needed at the edge: a retrained
  model that suddenly disagrees with the fleet baseline across an SNR
  bucket is exactly the continual-learning failure arXiv:2502.17168
  worries about).

``frame_source`` is pluggable (seed, n, snr) -> (iq, labels) so replay
buffers or recorded captures can stand in for the synthetic generator —
and so channel drift can be *injected*:
``repro_torch.channel.make_frame_source("doppler_drift", frame_len=...)``
shadow-evaluates both sides under a fading/CFO/timing-drift channel
instead of the clean dataset channel (tested: a drift-sensitive canary
rolls back, an equivalent one is not falsely rolled back).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.channel.scenario import stable_seed
from repro_torch.obs.metrics import default_registry

__all__ = ["MonitorConfig", "WindowResult", "CanaryMonitor"]

FrameSource = Callable[[int, int, float], Tuple[np.ndarray, np.ndarray]]


def _snr_bin_seed(snr_db: float) -> int:
    """Stable 32-bit seed offset for one SNR bucket.

    Hashes the bytes of the *float* (the shared
    :func:`repro_torch.channel.stable_seed` primitive), so fractional bins
    such as 0.5 and 0.9 draw distinct frames; equal to the reference's.
    """
    return stable_seed("snr-bin", snr_db)


def _default_frame_source(seed: int, n: int, snr_db: float,
                          frame_len: int, n_classes: int):
    from repro_torch.data.radioml import N_CLASSES, generate_batch

    classes = (tuple(range(n_classes)) if n_classes < N_CLASSES else None)
    iq, labels, _ = generate_batch(seed, n, snr_db=snr_db, classes=classes,
                                   frame_len=frame_len)
    return iq, labels


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    snr_bins: Tuple[float, ...] = (-10.0, 0.0, 10.0)
    frames_per_bin: int = 32
    window: int = 3              # rounds kept in the sliding window
    min_rounds: int = 2          # evidence floor before any decision
    promote_after: int = 3       # consecutive clean rounds to promote
    acc_drop_tol: float = 0.05   # max windowed per-bin score drop
    p99_factor: float = 2.0      # max canary p99 / baseline p99
    min_latency_samples: int = 20  # per side, before p99 is trusted
    score: str = "labels"        # or "agreement"
    seed: int = 20_260_801

    def __post_init__(self):
        if self.score not in ("labels", "agreement"):
            raise ValueError(f"score must be 'labels' or 'agreement', "
                             f"got {self.score!r}")


@dataclasses.dataclass
class WindowResult:
    """One shadow-evaluation round (per-SNR scores + served p99s)."""

    round: int
    baseline_acc: Dict[float, float]
    canary_acc: Dict[float, float]
    baseline_p99_ms: float
    canary_p99_ms: float
    wall_s: float


class CanaryMonitor:
    """Watches one canary against the production baseline on an engine.

    Pull-based: each :meth:`step` runs one evaluation round and returns
    the decision so far (``"pending"`` / ``"promote"`` / ``"rollback"``);
    :meth:`run` loops until a decision or ``max_rounds``.  Decisions are
    enacted on the engine (and registry, when attached) exactly once.
    """

    def __init__(
        self,
        engine,
        *,
        baseline: str,
        canary: str,
        config: Optional[MonitorConfig] = None,
        frame_source: Optional[FrameSource] = None,
        registry=None,
        canary_spec: Optional[str] = None,
    ):
        self.engine = engine
        self.baseline = baseline
        self.canary = canary
        self.config = config or MonitorConfig()
        if frame_source is None:
            width = engine.cfg.input_width  # frames must match the model
            n_cls = engine.cfg.n_classes    # labels must stay in range
            frame_source = (lambda seed, n, snr:
                            _default_frame_source(seed, n, snr, width,
                                                  n_cls))
        self.frame_source = frame_source
        self.registry = registry
        self.canary_spec = canary_spec
        self.history: List[WindowResult] = []
        self.decision = "pending"
        self.reason = ""
        self._round = 0
        self._clean_rounds = 0
        for label in (baseline, canary):
            engine.get_version(label)  # fail fast on unbound labels
        # structured registry mirror of the monitor's lifecycle
        reg = default_registry()
        self._m_rounds = reg.counter(
            "repro_canary_rounds_total",
            "Shadow-evaluation rounds run per canary",
            ("canary",)).labels(canary=canary)
        self._m_decisions = reg.counter(
            "repro_canary_decisions_total",
            "Terminal canary decisions by kind",
            ("decision", "canary"))
        self._m_clean = reg.gauge(
            "repro_canary_clean_rounds",
            "Consecutive clean (regression-free) rounds so far",
            ("canary",)).labels(canary=canary)

    # -- shadow evaluation --------------------------------------------------

    def _predict(self, label: str, iq: np.ndarray) -> np.ndarray:
        """Class ids via the version's own serving step (shadow path —
        does not enter the request queue, so it never skews served
        latency stats)."""
        return self.engine.get_version(label).step(iq).argmax(-1)

    def _score(self, preds: np.ndarray, labels: np.ndarray,
               ref: np.ndarray) -> float:
        target = labels if self.config.score == "labels" else ref
        return float((preds == target).mean())

    def evaluate_round(self) -> WindowResult:
        """One evaluation pass over every SNR bucket (no decision)."""
        cfg = self.config
        t0 = time.perf_counter()
        base_acc: Dict[float, float] = {}
        can_acc: Dict[float, float] = {}
        for snr in cfg.snr_bins:
            seed = cfg.seed + 7919 * self._round + _snr_bin_seed(snr)
            iq, labels = self.frame_source(seed, cfg.frames_per_bin, snr)
            base_preds = self._predict(self.baseline, iq)
            can_preds = self._predict(self.canary, iq)
            base_acc[snr] = self._score(base_preds, labels, base_preds)
            can_acc[snr] = self._score(can_preds, labels, base_preds)
        stats = self.engine.version_stats()
        res = WindowResult(
            round=self._round,
            baseline_acc=base_acc, canary_acc=can_acc,
            baseline_p99_ms=stats[self.baseline].p99_ms,
            canary_p99_ms=stats[self.canary].p99_ms,
            wall_s=time.perf_counter() - t0)
        self._round += 1
        self.history.append(res)
        if len(self.history) > cfg.window:
            del self.history[: -cfg.window]
        return res

    # -- decision rule ------------------------------------------------------

    def _windowed(self, pick) -> Dict[float, float]:
        """Mean per-SNR score over the sliding window."""
        out: Dict[float, List[float]] = {}
        for res in self.history:
            for snr, v in pick(res).items():
                out.setdefault(snr, []).append(v)
        return {snr: float(np.mean(vs)) for snr, vs in out.items()}

    def _check(self) -> Tuple[str, str]:
        cfg = self.config
        if self._round < cfg.min_rounds:
            return "pending", f"warming up ({self._round}/{cfg.min_rounds})"
        base = self._windowed(lambda r: r.baseline_acc)
        can = self._windowed(lambda r: r.canary_acc)
        regressed = {snr: (base[snr], can[snr]) for snr in base
                     if can[snr] < base[snr] - cfg.acc_drop_tol}
        if regressed:
            worst = min(regressed, key=lambda s: regressed[s][1] -
                        regressed[s][0])
            b, c = regressed[worst]
            return ("rollback",
                    f"accuracy regression at {sorted(regressed)} dB "
                    f"(worst {worst:+.0f} dB: canary {c:.3f} vs baseline "
                    f"{b:.3f}, tol {cfg.acc_drop_tol})")
        stats = self.engine.version_stats()
        bs, cs = stats[self.baseline], stats[self.canary]
        if (len(bs.latencies_s) >= cfg.min_latency_samples
                and len(cs.latencies_s) >= cfg.min_latency_samples
                and bs.p99_ms > 0
                and cs.p99_ms > cfg.p99_factor * bs.p99_ms):
            return ("rollback",
                    f"latency regression: canary p99 {cs.p99_ms:.1f}ms > "
                    f"{cfg.p99_factor}x baseline p99 {bs.p99_ms:.1f}ms")
        if self._clean_rounds + 1 >= cfg.promote_after:
            return ("promote",
                    f"{self._clean_rounds + 1} clean rounds across "
                    f"{len(base)} SNR bins")
        return "pending", f"clean round {self._clean_rounds + 1}"

    # -- actions ------------------------------------------------------------

    def _enact_rollback(self) -> None:
        self.engine.set_router(None)
        try:
            self.engine.remove_version(self.canary)
        except ValueError:
            # the canary had already been made primary (manual swap):
            # flip back to the baseline first, then drop it
            self.engine.swap_to(self.baseline)
            self.engine.remove_version(self.canary)

    def _enact_promote(self) -> None:
        from repro_torch.deploy.swap import mark_production

        self.engine.swap_to(self.canary)
        self.engine.set_router(None)
        mark_production(self.canary)
        if self.registry is not None and self.canary_spec:
            name, version = self.registry.resolve(self.canary_spec)
            self.registry.set_alias(name, "production", version)

    # -- public loop --------------------------------------------------------

    def step(self) -> str:
        """One evaluation round + decision; enacts promote/rollback once."""
        if self.decision != "pending":
            return self.decision
        self.evaluate_round()
        self._m_rounds.inc()
        decision, reason = self._check()
        self.reason = reason
        if decision == "rollback":
            self._enact_rollback()
            self.decision = "rollback"
        elif decision == "promote":
            self._enact_promote()
            self.decision = "promote"
        elif self._round >= self.config.min_rounds:
            # warm-up rounds gather evidence but are not regression-checked
            # — only checked-and-clean rounds count toward promote_after
            self._clean_rounds += 1
        self._m_clean.set(self._clean_rounds)
        if self.decision != "pending":
            self._m_decisions.labels(decision=self.decision,
                                     canary=self.canary).inc()
        return self.decision

    def run(self, max_rounds: int = 10,
            sleep_s: float = 0.0) -> str:
        """Step until a decision or ``max_rounds`` evaluation rounds."""
        for _ in range(max_rounds):
            if self.step() != "pending":
                break
            if sleep_s:
                time.sleep(sleep_s)
        return self.decision

    def summary(self) -> Dict[str, Any]:
        return {
            "decision": self.decision,
            "reason": self.reason,
            "rounds": self._round,
            "score": self.config.score,
            "windowed_baseline": self._windowed(lambda r: r.baseline_acc),
            "windowed_canary": self._windowed(lambda r: r.canary_acc),
        }
