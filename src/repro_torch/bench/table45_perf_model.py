"""Paper Tables IV-V: throughput / latency / power / FoM vs weight density.

Port of ``benchmarks/table45_perf_model.py``.  The FPGA measurements are
re-derived from the framework's models:

* **latency** — ``CycleModel``: per-timestep conv iterations REPS(d) =
  NNZ(d) + extra + empty; the FC stages are a density-independent floor
  (the WM method skips work, not slots).  Calibrated on ONE paper row
  (100% density), then predicted for all others.
* **throughput** — structural: the ingest stage's cadence (23.5 MS/s at
  137 MHz) is density-independent.
* **power** — activity-proportional ``PowerModel`` least-squares-fitted to
  Table V (accum rate, fetched-bit rate, utilization), reported with
  residuals.
* **FoM** — eq. (4) with the paper's LUT counts.

Only the weight shapes of the paper model enter, so the numpy-seeded
init gives the reference's figures exactly.

    python -m repro_torch.bench.table45_perf_model
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.saocds_amc import CONFIG as SNN_CONFIG
from repro_torch.core.cost_model import (
    PAPER_BASELINE,
    PAPER_TABLE5,
    CycleModel,
    PowerModel,
    fom,
)
from repro_torch.models.snn import init_snn

NAME = "table45_perf_model"

PAPER_LUT = 83_000  # ~ mean SAOCDS LUT count (Table V, stable across rows)


def run() -> dict:
    cfg = SNN_CONFIG
    params = init_snn(0, cfg)
    conv_weights = tuple(
        int(np.prod(layer["w"].shape)) for layer in params["conv"]
    )  # (352, 5632, 10240)

    cyc = CycleModel(conv_weight_counts=conv_weights,
                     timesteps=cfg.timesteps).calibrate()
    rows = []
    for d, (p_watt, p_lat, p_acc) in sorted(PAPER_TABLE5.items()):
        lat = cyc.latency_us(d)
        rows.append({
            "density": d,
            "latency_us": lat,
            "paper_latency_us": p_lat,
            "latency_err_pct": 100 * (lat - p_lat) / p_lat,
            "throughput_msps": cyc.throughput_msps(),
            "paper_dyn_w": p_watt,
        })

    # power fit: activity features per density
    feats, watts = [], []
    for d, (p_watt, p_lat, _) in sorted(PAPER_TABLE5.items()):
        nnz = sum(max(1, round(c * d)) for c in conv_weights)
        accum_rate = nnz * 0.5 * cfg.timesteps / (p_lat * 1e-6)  # ~50% IFM
        bit_rate = (nnz * 16 + nnz * 4) / (p_lat * 1e-6)
        util = min(1.0, 453.14 / p_lat)  # busy fraction vs min-latency row
        feats.append([accum_rate, bit_rate, util])
        watts.append(p_watt)
    pm = PowerModel().fit(np.asarray(feats), np.asarray(watts))
    fit_err = [float(pm.predict(*f) - w) for f, w in zip(feats, watts)]
    for r, err in zip(rows, fit_err):
        r["power_model_w"] = r["paper_dyn_w"] + 0  # measured
        r["power_fit_err_w"] = err
        r["fom"] = fom(PAPER_LUT, r["paper_dyn_w"], r["throughput_msps"])

    baseline = {
        **PAPER_BASELINE,
        "fom": fom(74578, PAPER_BASELINE["dyn_w"],
                   PAPER_BASELINE["throughput_msps"]),
        "throughput_ratio": rows[0]["throughput_msps"]
        / PAPER_BASELINE["throughput_msps"],
        "power_ratio_at_100": PAPER_TABLE5[1.0][0] / PAPER_BASELINE["dyn_w"],
    }
    return {"rows": rows, "baseline": baseline,
            "conv_weights": conv_weights,
            "power_coeffs": [pm.c_acc, pm.c_bit, pm.c_util]}


def format_table(res: dict) -> str:
    b = res["baseline"]
    lines = [
        "Tables IV-V — cycle/power model vs paper measurements",
        f"  conv weights/layer: {res['conv_weights']}",
        f"  baseline [12]: {b['throughput_msps']} MS/s, {b['dyn_w']} W "
        f"-> SAOCDS x{b['throughput_ratio']:.2f} throughput, "
        f"x{b['power_ratio_at_100']:.2f} power at 100% density",
        f"  {'density':>8s}{'lat model us':>13s}{'lat paper us':>13s}"
        f"{'err%':>7s}{'thr MS/s':>9s}{'P fit err W':>12s}{'FoM':>9s}",
    ]
    for r in res["rows"]:
        lines.append(
            f"  {r['density']:8.2f}{r['latency_us']:13.1f}"
            f"{r['paper_latency_us']:13.1f}{r['latency_err_pct']:7.1f}"
            f"{r['throughput_msps']:9.1f}{r['power_fit_err_w']:12.3f}"
            f"{r['fom']:9.1f}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(format_table(run()))
