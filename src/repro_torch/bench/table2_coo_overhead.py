"""Paper Table II: COO storage overhead vs dense, per conv layer.

Port of ``benchmarks/table2_coo_overhead.py``: the exact bit widths
(W.D / W.RI / W.CI), dense totals, COO totals and break-even densities of
the paper's three conv layers, each held to the paper's row.

    python -m repro_torch.bench.table2_coo_overhead
"""
from __future__ import annotations

from repro_torch.core.sparse_format import (
    break_even_density,
    coo_bit_widths,
    coo_storage_bits,
    dense_storage_bits,
)

NAME = "table2_coo_overhead"

# (layer, kw, ic, oc) for the paper's three conv layers
LAYERS = [("L1", 11, 2, 16), ("L2", 11, 16, 32), ("L3", 5, 32, 64)]
PAPER = {  # layer -> (RI bits, CI bits, total len, amount, dense bits, break-even %)
    "L1": (5, 4, 25, 352, 5632, 64.00),
    "L2": (9, 4, 29, 5632, 90112, 55.17),
    "L3": (11, 3, 30, 10240, 163840, 53.33),
}


def run() -> dict:
    rows = []
    for name, kw, ic, oc in LAYERS:
        d_bits, ri, ci = coo_bit_widths(kw, ic, oc)
        total_len = d_bits + ri + ci
        amount = kw * ic * oc
        dense = dense_storage_bits(kw, ic, oc)
        be = break_even_density(kw, ic, oc)
        p = PAPER[name]
        rows.append({
            "layer": name, "ri_bits": ri, "ci_bits": ci,
            "total_len": total_len, "amount": amount,
            "dense_bits": dense,
            "coo_bits_at_X1": coo_storage_bits(kw, ic, oc, 1.0),
            "break_even": be,
            "paper": p,
            "match": (ri, ci, total_len, amount, dense) == p[:5]
            and abs(be * 100 - p[5]) < 0.01,
        })
    return {"rows": rows}


def format_table(res: dict) -> str:
    lines = [
        "Table II — COO vs dense storage (paper values in [])",
        f"  {'layer':6s}{'RI':>4s}{'CI':>4s}{'len':>5s}{'amount':>8s}"
        f"{'dense-bit':>10s}{'break-even':>12s}{'ok':>4s}",
    ]
    for r in res["rows"]:
        p = r["paper"]
        lines.append(
            f"  {r['layer']:6s}{r['ri_bits']:>2d}[{p[0]:d}]"
            f"{r['ci_bits']:>2d}[{p[1]:d}]{r['total_len']:>3d}[{p[2]:d}]"
            f"{r['amount']:>6d}[{p[3]:d}]{r['dense_bits']:>8d}[{p[4]:d}]"
            f"  {r['break_even'] * 100:6.2f}%[{p[5]:.2f}%]"
            f"{'Y' if r['match'] else 'N':>4s}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(format_table(run()))
