"""Scenario-robustness evaluation harness.

Port of ``repro/eval/robustness.py``.  Sweeps **(channel scenario x SNR
grid x backend)** through plan-compiled batched forwards and reduces each
cell to accuracy, the per-modulation confusion matrix and per-class
accuracies, serialized as one JSON-ready report with an accuracy surface
(scenario x SNR matrix) for the primary backend.

Frames are generated clean and impaired by the scenario's channel at each
grid SNR, on the evaluation's device; the ``clean`` section evaluates the
legacy dataset channel at the same SNRs.  Every backend is one bound plan
step (Σ-Δ encode on the device, then the plan's preferred batch: one
launch of the whole-network kernel for ``cuda_fused``, the per-layer
kernels for ``cuda``), built once and reused by every cell.  A backend
that raises fails the evaluation: nothing is dropped from the report.

Deterministic end to end: cell ``(scenario, snr)`` draws its frames and
its channel from a seed derived by a stable hash of the scenario name and
the *float* SNR, the reference's cell seeds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.channel import (
    ChannelScenario,
    apply_scenario_np,
    get_scenario,
    stable_seed,
    suite_scenarios,
)
from repro_torch.data.pipeline import sigma_delta_encode_batch
from repro_torch.data.radioml import MODULATIONS, generate_batch
from repro_torch.device import resolve_device
from repro_torch.models.graph import compile_snn
from repro_torch.models.snn import SNNConfig
from repro_torch.plan import compile_plan

__all__ = ["RobustnessConfig", "evaluate_robustness", "stable_cell_seed",
           "format_report"]

DEFAULT_SNR_GRID = (-10.0, 0.0, 10.0, 18.0)


def stable_cell_seed(tag: str, snr_db: float) -> int:
    """Stable 32-bit seed for one sweep cell (hashes the bytes of the
    float SNR, so fractional bins like 0.5 and 0.9 draw distinct frames)."""
    return stable_seed(tag, snr_db)


@dataclasses.dataclass(frozen=True)
class RobustnessConfig:
    """One robustness sweep: which scenarios, SNRs, backends, and how much."""

    suite: str = "default"               # suite name or comma-joined names
    snr_grid: Tuple[float, ...] = DEFAULT_SNR_GRID
    frames_per_cell: int = 64
    backends: Tuple[str, ...] = ("goap",)
    seed: int = 0
    include_clean: bool = True           # legacy-channel reference section
    agreement_atol: float = 1e-5         # cross-backend logit tolerance


def _confusion(labels: np.ndarray, preds: np.ndarray, n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (labels, preds), 1)
    return cm


def _cell_record(labels: np.ndarray, preds_by_backend: Dict[str, np.ndarray],
                 n_classes: int, primary: str) -> Dict[str, Any]:
    cm = _confusion(labels, preds_by_backend[primary], n_classes)
    row = cm.sum(axis=1)
    per_class = np.divide(np.diag(cm), row, out=np.zeros(n_classes),
                          where=row > 0)
    return {
        "n_frames": int(labels.shape[0]),
        "accuracy": {b: float((p == labels).mean())
                     for b, p in preds_by_backend.items()},
        "confusion": cm.tolist(),
        "per_class_accuracy": [round(float(v), 4) for v in per_class],
    }


def _snr_key(snr: float) -> str:
    return f"{float(snr):+.1f}"


def _impair(sc: ChannelScenario, iq: np.ndarray, snrs: np.ndarray, seed: int,
            device: torch.device) -> np.ndarray:
    """The channel step of one cell: ``iq`` through the scenario's channel
    at the frames' SNRs, drawn from ``seed``, on ``device``."""
    return apply_scenario_np(sc, iq, snrs, seed, device=device)


def _backend_step(program, params, model_cfg, backend: str, masks, quant_fn,
                  device):
    """(B, 2, L) numpy I/Q -> (B, n_classes) float logits on the host,
    through one bound plan of ``backend``."""
    plan = compile_plan(program, params, masks=masks, quant_fn=quant_fn,
                        assignment=backend, device=device)
    batch = plan.preferred_batch()
    osr = model_cfg.timesteps
    if backend == "fixed":
        # the integer Σ-Δ front end and integer logits, dequantized onto the
        # float backends' logit scale (argmax-invariant), so cross-backend
        # |dlogit| measures the genuine float-vs-fixed divergence
        from repro_torch.fixed import fixed_encode_batch, fixed_logit_scale

        scale = fixed_logit_scale(params, model_cfg, masks=masks,
                                  quant_fn=quant_fn)

        def forward(x):
            return batch(fixed_encode_batch(x, osr)).to(torch.float32) * scale
    else:
        def forward(x):
            return batch(sigma_delta_encode_batch(x, osr))

    def step(iq: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.as_tensor(iq, dtype=torch.float32, device=device)
            return forward(x).cpu().numpy()

    return step


def evaluate_robustness(
    params,
    model_cfg: SNNConfig,
    eval_cfg: Optional[RobustnessConfig] = None,
    *,
    masks=None,
    quant_fn=None,
    scenarios: Optional[Sequence[Union[str, ChannelScenario]]] = None,
    device=None,
) -> Dict[str, Any]:
    """Run the full (scenario x SNR x backend) sweep on ``device`` (the
    card unless ``device="cpu"``); returns the report.

    ``scenarios`` overrides the config suite (names or
    :class:`ChannelScenario` instances).  The report is pure
    JSON-serializable builtins.
    """
    dev = resolve_device(device)
    cfg = eval_cfg or RobustnessConfig()
    scen = (tuple(suite_scenarios(cfg.suite)) if scenarios is None else
            tuple(get_scenario(s) for s in scenarios))
    program = compile_snn(model_cfg)
    n_classes = model_cfg.n_classes
    # reduced configs classify a class subset: labels must stay in range
    classes = (tuple(range(n_classes))
               if n_classes < len(MODULATIONS) else None)
    primary = cfg.backends[0]

    # one bound step per backend; every cell reuses it
    steps = {b: _backend_step(program, params, model_cfg, b, masks, quant_fn,
                              dev)
             for b in cfg.backends}

    agreement = {"atol": cfg.agreement_atol, "max_abs_logit_diff": 0.0,
                 "worst_pair": None}
    wall_by_backend = {b: 0.0 for b in cfg.backends}

    def _cell(iq: np.ndarray, labels: np.ndarray) -> Dict[str, Any]:
        preds, logits_by = {}, {}
        for b in cfg.backends:
            t0 = time.perf_counter()
            logits = steps[b](iq)      # ends in the copy to the host
            wall_by_backend[b] += time.perf_counter() - t0
            logits_by[b] = logits
            preds[b] = logits.argmax(-1)
        for b in cfg.backends[1:]:
            d = float(np.abs(logits_by[b] - logits_by[primary]).max())
            if d > agreement["max_abs_logit_diff"]:
                agreement["max_abs_logit_diff"] = d
                agreement["worst_pair"] = [primary, b]
        return _cell_record(labels, preds, n_classes, primary)

    report: Dict[str, Any] = {
        "config": {
            "suite": cfg.suite,
            "scenarios": [s.name for s in scen],
            "snr_grid": [float(s) for s in cfg.snr_grid],
            "frames_per_cell": cfg.frames_per_cell,
            "backends": list(cfg.backends),
            "seed": cfg.seed,
            "model": {"input_width": model_cfg.input_width,
                      "timesteps": model_cfg.timesteps,
                      "n_classes": n_classes},
        },
        "modulations": list(MODULATIONS[:n_classes]),
        "scenarios": {},
    }

    if cfg.include_clean:
        clean: Dict[str, Any] = {}
        for snr in cfg.snr_grid:
            seed = cfg.seed + stable_cell_seed("clean", snr)
            iq, labels, _ = generate_batch(seed, cfg.frames_per_cell,
                                           snr_db=snr, classes=classes,
                                           frame_len=model_cfg.input_width)
            clean[_snr_key(snr)] = _cell(iq, labels)
        report["clean"] = clean

    for sc in scen:
        per_snr: Dict[str, Any] = {}
        for snr in cfg.snr_grid:
            seed = cfg.seed + stable_cell_seed(sc.name, snr)
            iq, labels, snrs = generate_batch(
                seed, cfg.frames_per_cell, snr_db=snr, classes=classes,
                frame_len=model_cfg.input_width, apply_channel=False)
            per_snr[_snr_key(snr)] = _cell(_impair(sc, iq, snrs, seed, dev),
                                           labels)
        accs = [per_snr[_snr_key(s)]["accuracy"][primary]
                for s in cfg.snr_grid]
        report["scenarios"][sc.name] = {
            "per_snr": per_snr,
            "mean_accuracy": float(np.mean(accs)),
        }

    # the accuracy surface (primary backend): scenario rows x SNR columns
    report["surface"] = {
        "backend": primary,
        "snrs": [float(s) for s in cfg.snr_grid],
        "scenarios": [s.name for s in scen],
        "accuracy": [
            [report["scenarios"][s.name]["per_snr"][_snr_key(snr)]
             ["accuracy"][primary] for snr in cfg.snr_grid]
            for s in scen
        ],
    }
    if len(cfg.backends) > 1:
        agreement["agrees"] = bool(
            agreement["max_abs_logit_diff"] <= cfg.agreement_atol)
        report["agreement"] = agreement
    report["wall_s_by_backend"] = {b: round(w, 3)
                                   for b, w in wall_by_backend.items()}
    return report


def format_report(report: Dict[str, Any]) -> str:
    """Human-readable accuracy surface (what the CLI prints)."""
    surf = report["surface"]
    snrs, names = surf["snrs"], surf["scenarios"]
    w = max(len(n) for n in names + ["clean (legacy ch.)"]) + 2
    lines = [f"accuracy surface [{surf['backend']}] "
             f"({report['config']['frames_per_cell']} frames/cell)",
             " " * w + "".join(f"{s:>9.1f}dB" for s in snrs)]
    if "clean" in report:
        primary = surf["backend"]
        accs = [report["clean"][_snr_key(s)]["accuracy"][primary]
                for s in snrs]
        lines.append(f"{'clean (legacy ch.)':<{w}}"
                     + "".join(f"{a:>11.3f}" for a in accs))
    for name, row in zip(names, surf["accuracy"]):
        lines.append(f"{name:<{w}}" + "".join(f"{a:>11.3f}" for a in row))
    if "agreement" in report:
        ag = report["agreement"]
        lines.append(f"cross-backend max |dlogit| = "
                     f"{ag['max_abs_logit_diff']:.2e} "
                     f"({'OK' if ag['agrees'] else 'DISAGREES'} at atol "
                     f"{ag['atol']:g})")
    return "\n".join(lines)
