"""Paper Table I: SW vs GOAP fetch/accumulation counts (Fig. 3 example).

Port of ``benchmarks/table1_goap_vs_sw.py``.  The (1,3,2,4) kernel /
(1,6,2) IFM example at 50% temporal + 50% spatial sparsity must give SW
(24, 96, 48) vs GOAP (48, 12, 24) and fetched-bit totals 1560 vs 240
(= 15.4%).  A sweep over random sparsities shows how the advantage
scales (paper §III-C.2).

    python -m repro_torch.bench.table1_goap_vs_sw
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.cost_model import bits_fetched, goap_conv_counts, sw_conv_counts
from repro_torch.core.sparse_format import coo_from_dense

NAME = "table1_goap_vs_sw"


def fig3_example():
    kw, ic, oc, wi = 3, 2, 4, 6
    k = np.zeros((kw, ic, oc), dtype=np.float32)
    for o in range(oc):
        k[1, 0, o], k[0, 1, o], k[2, 1, o] = 1.0, 2.0, 3.0
    ifm = np.zeros((ic, wi), dtype=np.float32)
    ifm[0, [1, 3, 5]] = 1
    ifm[1, [0, 2, 4]] = 1
    return k, ifm


def run() -> dict:
    k, ifm = fig3_example()
    sw = sw_conv_counts(ifm, k.shape)
    gp = goap_conv_counts(ifm, coo_from_dense(k))
    exact = {
        "SW": {**sw.asdict(), "fetched_bits": bits_fetched(sw)},
        "GOAP": {**gp.asdict(), "fetched_bits": bits_fetched(gp)},
        "paper_SW": {"input_fetches": 24, "weight_fetches": 96,
                     "accumulations": 48, "fetched_bits": 1560},
        "paper_GOAP": {"input_fetches": 48, "weight_fetches": 12,
                       "accumulations": 24, "fetched_bits": 240},
    }
    exact["match"] = (exact["SW"] == exact["paper_SW"]
                      and exact["GOAP"] == exact["paper_GOAP"])

    # sweep: bit-traffic ratio GOAP/SW against weight density (a larger
    # kernel), the reference's draws from the same seed
    rng = np.random.default_rng(0)
    sweep = []
    for wd in (1.0, 0.75, 0.5, 0.25, 0.1):
        for sd in (0.5,):
            kw, ic, oc, wi = 11, 16, 32, 64
            kk = ((rng.random((kw, ic, oc)) < wd)
                  * rng.normal(size=(kw, ic, oc))).astype(np.float32)
            f = (rng.random((ic, wi)) < sd).astype(np.float32)
            s = sw_conv_counts(f, kk.shape)
            g = goap_conv_counts(f, coo_from_dense(kk))
            sweep.append({
                "w_density": wd, "ifm_density": sd,
                "bits_ratio": bits_fetched(g) / bits_fetched(s),
                "accum_ratio": g.accumulations / max(1, s.accumulations),
            })
    return {"exact": exact, "sweep": sweep}


def format_table(res: dict) -> str:
    e = res["exact"]
    lines = [
        "Table I — SW vs GOAP on the Fig. 3 example (paper values in [])",
        f"{'':14s}{'#in-fetch':>10s}{'#w-fetch':>10s}{'#accum':>8s}{'bits':>7s}",
    ]
    for m in ("SW", "GOAP"):
        c, p = e[m], e[f"paper_{m}"]
        lines.append(
            f"  {m:12s}{c['input_fetches']:>6d}[{p['input_fetches']:>3d}]"
            f"{c['weight_fetches']:>6d}[{p['weight_fetches']:>3d}]"
            f"{c['accumulations']:>4d}[{p['accumulations']:>3d}]"
            f"{c['fetched_bits']:>5d}[{p['fetched_bits']:>5d}]")
    lines.append(f"  exact match: {e['match']}")
    lines.append("  sweep (11x16x32 kernel, 50% IFM): w-density -> GOAP/SW bits")
    for r in res["sweep"]:
        lines.append(f"    {r['w_density']:.2f} -> bits {r['bits_ratio']:.3f}  "
                     f"accum {r['accum_ratio']:.3f}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(format_table(run()))
