"""Robustness-evaluation driver: ``python -m repro_torch.launch.eval``.

Sweeps the :mod:`repro_torch.channel` scenario suite x an SNR grid x one
or more execution backends through
:func:`repro_torch.eval.evaluate_robustness` on the card (``--device cpu``
for the CPU), prints the accuracy surface, and writes the full JSON report
(per-(scenario, SNR) accuracy and per-modulation confusion matrices).
Exits 1 when the backends disagree beyond the report's tolerance.

Examples::

    # default suite, the fused kernel against the per-layer kernels and
    # the plain goap backend, fresh 50%-density weights (paper model)
    python -m repro_torch.launch.eval --suite default \\
        --backend cuda_fused,cuda,goap

    # the reduced config on the CPU
    python -m repro_torch.launch.eval --reduced --suite quick --device cpu

    # a trained model from the lifecycle registry
    python -m repro_torch.launch.eval --registry ./registry --model amc@production
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.channel import SUITES
from repro_torch.eval import RobustnessConfig, evaluate_robustness, format_report

__all__ = ["main", "REDUCED_SMOKE_CFG"]

# A reduced config for smoke runs: same topology family as the paper
# model, ~100x cheaper to bind and sweep.
REDUCED_SMOKE_CFG = dict(
    conv_specs=((5, 2, 8), (5, 8, 16)),
    pool=2,
    fc_specs=((128, 32), (32, 11)),
    input_width=32,
    timesteps=4,
    n_classes=11,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--suite", default="default",
                    help=f"scenario suite ({', '.join(sorted(SUITES))}) or "
                         "comma-joined scenario names")
    ap.add_argument("--backend", default="goap",
                    help="backend, or comma-joined list (first is primary; "
                         "extra backends add a cross-backend agreement "
                         "check)")
    ap.add_argument("--snr", default="-10,0,10,18",
                    help="comma-joined SNR grid in dB")
    ap.add_argument("--frames", type=int, default=64,
                    help="frames per (scenario, SNR) cell")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--density", type=float, default=0.5,
                    help="mask density for fresh random weights")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced smoke config instead of the paper model")
    ap.add_argument("--no-clean", action="store_true",
                    help="skip the legacy-channel clean reference section")
    ap.add_argument("--registry", default=None, metavar="DIR",
                    help="evaluate a model from a deploy registry")
    ap.add_argument("--model", default="amc", metavar="NAME[@VER|@ALIAS]")
    ap.add_argument("--out", default="robustness_report.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)

    lsq_scales, quant_bits = None, 16
    if args.registry:
        from repro_torch.deploy import ModelRegistry

        loaded = ModelRegistry(args.registry).load(args.model)
        params, masks, model_cfg = loaded.params, loaded.masks, loaded.cfg
        lsq_scales = loaded.lsq_scales
        quant_bits = loaded.version.quant_bits
        print(f"registry: evaluating {loaded.version.spec} "
              f"(digest {loaded.version.digest[:12]}…)")
    else:
        from repro_torch.configs.saocds_amc import CONFIG
        from repro_torch.models.snn import SNNConfig, init_snn
        from repro_torch.train.pruning import make_mask_pytree

        model_cfg = (SNNConfig(**REDUCED_SMOKE_CFG) if args.reduced
                     else CONFIG)
        params = init_snn(args.seed, model_cfg)
        masks = make_mask_pytree(params, args.density)

    quant_fn = None
    if lsq_scales is not None:
        from repro_torch.train.lsq import make_serving_quant_fn

        quant_fn = make_serving_quant_fn(lsq_scales, quant_bits)

    eval_cfg = RobustnessConfig(
        suite=args.suite,
        snr_grid=tuple(float(s) for s in args.snr.split(",")),
        frames_per_cell=args.frames,
        backends=tuple(b.strip() for b in args.backend.split(",")),
        seed=args.seed,
        include_clean=not args.no_clean,
    )
    report = evaluate_robustness(params, model_cfg, eval_cfg, masks=masks,
                                 quant_fn=quant_fn, device=args.device)
    print(format_report(report))
    print("wall per backend: " + ", ".join(
        f"{b}={w:.1f}s" for b, w in report["wall_s_by_backend"].items()))
    out = pathlib.Path(args.out)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    if "agreement" in report and not report["agreement"]["agrees"]:
        print("FAIL: backends disagree on impaired frames")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
