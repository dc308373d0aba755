"""Model lifecycle example: publish -> serve -> canary -> promote ->
rollback, end to end.

Port of ``examples/amc_deploy.py``.  The paper's deployment target is a
long-lived cognitive-radio edge node; this example walks the whole
continual-update loop the deploy subsystem supports:

1. train the paper model briefly and **publish** it to a versioned
   registry (``production`` alias);
2. train a little more and publish the update (``staging``);
3. serve production through the async tier, then bind staging as a
   **canary** taking a slice of the batches;
4. let the :class:`CanaryMonitor` shadow-evaluate both versions per SNR
   bucket and **auto-promote** the clean canary via the atomic hot-swap;
5. publish a deliberately-broken version and watch the monitor
   **auto-roll-back** the moment its per-SNR scores collapse.

Run:  PYTHONPATH=src python -m repro_torch.examples.amc_deploy
      [--registry DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import torch

from repro_torch.configs.saocds_amc import CONFIG as SNN_CONFIG
from repro_torch.data.radioml import generate_batch
from repro_torch.deploy import (
    CanaryMonitor,
    ModelRegistry,
    MonitorConfig,
    canary_router,
    publish_from_trainer,
)
from repro_torch.device import resolve_device
from repro_torch.serve import AsyncAMCServeEngine
from repro_torch.train.trainer import SNNTrainer, TrainerConfig
from repro_torch.tree import tree_map

__all__ = ["main", "run"]


def run(args) -> dict:
    """The lifecycle on ``args.device``; returns what it reports."""
    dev = resolve_device(args.device)
    tmp = None
    registry_dir = args.registry
    if registry_dir is None:
        tmp = tempfile.TemporaryDirectory()
        registry_dir = tmp.name
    try:
        return _lifecycle(args, dev, ModelRegistry(registry_dir, device=dev))
    finally:
        if tmp is not None:
            tmp.cleanup()


def _lifecycle(args, dev, registry) -> dict:
    # -- 1-2: train and publish two versions --------------------------------
    print(f"[1/5] training {args.train_steps} steps at density "
          f"{args.density}")
    trainer = SNNTrainer(SNN_CONFIG, TrainerConfig(
        total_steps=args.train_steps, batch_size=48, lr=2e-3,
        final_density=args.density, snr_db=10.0), device=dev)
    trainer.run()
    v1 = publish_from_trainer(registry, "amc", trainer, alias="production",
                              metrics={"train_steps": trainer.step})
    print(f"      published {v1.spec} (digest {v1.digest[:12]}…, plan "
          f"{str(v1.plan_digest)[:12]}…) -> production")

    print(f"[2/5] continuing training {args.train_steps // 2} more steps")
    trainer.run(steps=max(1, args.train_steps // 2))
    v2 = publish_from_trainer(registry, "amc", trainer, alias="staging",
                              metrics={"train_steps": trainer.step})
    print(f"      published {v2.spec} -> staging")

    # -- 3: serve production, canary the update -----------------------------
    prod = registry.load("amc@production")
    engine = AsyncAMCServeEngine(prod.params, prod.cfg, masks=prod.masks,
                                 backend="auto", max_batch=32,
                                 version_label=v1.spec, device=dev)
    try:
        print(f"[3/5] serving {v1.spec} on backend '{engine.backend}'")
        iq, labels, _ = generate_batch(seed=4242, batch=args.requests,
                                       snr_db=10.0)
        preds = engine.classify(iq)
        prod_acc = float((preds == labels).mean())
        print(f"      production accuracy on {args.requests} frames: "
              f"{prod_acc:.3f}")

        staging = registry.load("amc@staging")
        engine.bind_version(v2.spec, staging.params, staging.masks)
        engine.set_router(canary_router(v1.spec, v2.spec, args.canary_pct))
        engine.classify(iq)  # traffic now splits across both versions

        # -- 4: monitor promotes the clean canary ---------------------------
        # labels scoring (the synthetic generator doubles as a labeled
        # replay buffer): the canary must stay within tolerance of the
        # baseline's per-SNR accuracy
        mon = CanaryMonitor(engine, baseline=v1.spec, canary=v2.spec,
                            config=MonitorConfig(
                                snr_bins=(0.0, 10.0), frames_per_bin=32,
                                score="labels", acc_drop_tol=0.3,
                                min_rounds=1, promote_after=2),
                            registry=registry, canary_spec=v2.spec)
        promote = mon.run(max_rounds=5)
        print(f"[4/5] monitor on {v2.spec}: {promote} ({mon.reason})")
        assert promote == "promote", "a healthy canary should promote"
        print(f"      primary is now {engine.active_version}; production "
              f"alias -> v{registry.resolve('amc')[1]}")
        engine.classify(iq)  # traffic now lands on the promoted version

        # -- 5: a broken update rolls back automatically --------------------
        # fault injection: a "corrupted retrain" whose logit head is
        # permuted — every prediction lands one class off, a regression the
        # agreement score (no ground truth needed) catches deterministically
        broken = tree_map(torch.clone, staging.params)
        broken["fc"][-1] = dict(broken["fc"][-1], w=torch.roll(
            broken["fc"][-1]["w"], 1, dims=1))
        broken_masks = tree_map(torch.clone, staging.masks)
        broken_masks["fc"][-1] = torch.roll(broken_masks["fc"][-1], 1, dims=1)
        v3 = registry.publish("amc", broken, SNN_CONFIG, masks=broken_masks,
                              metrics={"note": "fault-injection demo"})
        engine.bind_version(v3.spec, broken, broken_masks)
        engine.set_router(canary_router(v2.spec, v3.spec, args.canary_pct))
        mon = CanaryMonitor(engine, baseline=v2.spec, canary=v3.spec,
                            config=MonitorConfig(
                                snr_bins=(-10.0, 0.0, 10.0), frames_per_bin=16,
                                score="agreement", acc_drop_tol=0.5,
                                min_rounds=2),
                            registry=registry, canary_spec=v3.spec)
        rollback = mon.run(max_rounds=5)
        print(f"[5/5] monitor on broken {v3.spec}: {rollback} ({mon.reason})")
        assert rollback == "rollback", "a broken canary should roll back"
        assert engine.active_version == v2.spec

        print("\nper-version serving stats:")
        stats = engine.version_stats()
        for label, st in stats.items():
            marker = "*" if label == engine.active_version else " "
            print(f"  {marker}{label:10s} requests={st.requests:5d} "
                  f"batches={st.batches:4d} p99={st.p99_ms:.1f}ms")
        print(f"registry versions: {registry.versions('amc')}, aliases "
              f"{registry.aliases('amc')}")
        return {"versions": registry.versions("amc"),
                "aliases": registry.aliases("amc"),
                "production_accuracy": prod_acc, "promote": promote,
                "rollback": rollback, "active": engine.active_version,
                "requests": {k: st.requests for k, st in stats.items()}}
    finally:
        engine.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--registry", default=None,
                    help="registry directory (default: a temp dir)")
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--canary-pct", type=float, default=25.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    run(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
