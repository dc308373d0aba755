"""Content-addressed, versioned model registry for the AMC serving tier.

Port of ``repro/deploy/registry.py``, with the same on-disk format, so a
registry written by either package loads in the other::

    <root>/<name>/v0001/{arrays.npz, manifest.json}
    <root>/<name>/v0002/...
    <root>/<name>/aliases.json

Every published model is an immutable, content-hashed **version**: params
+ pruning masks + LSQ quantization state + the config that shapes them,
written atomically (tmp dir + ``os.replace``), with named **aliases**
(``production``, ``staging``) that the serving tier resolves at bind time.
``arrays.npz`` holds each group's leaves as ``<group>_NNNNN`` in
``jax.tree_util`` order (:mod:`repro_torch.tree`), and the digest covers
the config and every leaf in that order, as the reference's does: the
same content gets the same digest in both packages, and re-publishing it
returns the existing version.

Publishing also compiles the version's port plan on the registry's device
through the default plan cache (warming its disk tier, so a later
hot-swap bind finds the COO/schedule artifacts on disk) and records the
plan's digest in the manifest.  A reference-written manifest's
``plan_digest`` names a reference plan: it is kept as recorded and never
used as a key of the port's cache.

The root defaults to ``REPRO_TORCH_REGISTRY_DIR``, else
``~/.cache/repro_torch/registry`` (beside the port's plan cache).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import re
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.snn import SNNConfig, init_snn
from repro_torch.plan.cache import default_store_root
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = [
    "ModelVersion",
    "LoadedModel",
    "ModelRegistry",
    "publish_from_trainer",
    "publish_from_checkpoint",
]

ENV_DIR = "REPRO_TORCH_REGISTRY_DIR"

_VERSION_RE = re.compile(r"^v(\d{4,})$")
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")

# Manifest format version (the reference's): bump on incompatible changes.
_FORMAT = 1


def _default_dir() -> pathlib.Path:
    env = os.environ.get(ENV_DIR)
    if env:
        return pathlib.Path(env).expanduser()
    return default_store_root() / "registry"


# ---------------------------------------------------------------------------
# (De)serialization helpers.
# ---------------------------------------------------------------------------

def _cfg_to_json(cfg: SNNConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _cfg_from_json(d: Dict[str, Any]) -> SNNConfig:
    # JSON turns the nested spec tuples into lists; restore them.
    d = dict(d)
    d["conv_specs"] = tuple(tuple(s) for s in d["conv_specs"])
    d["fc_specs"] = tuple(tuple(s) for s in d["fc_specs"])
    return SNNConfig(**d)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_group(group: str, tree) -> Dict[str, np.ndarray]:
    return {f"{group}_{i:05d}": _host(leaf)
            for i, leaf in enumerate(tree_leaves(tree))}


def _unflatten_group(group: str, data, like) -> Any:
    """Rebuild a tree shaped ``like`` from npz entries ``group_NNNNN``, as
    CPU tensors."""
    leaves = tree_leaves(like)
    keys = sorted(k for k in data.files if k.startswith(f"{group}_"))
    if len(keys) != len(leaves):
        raise ValueError(
            f"registry entry has {len(keys)} '{group}' leaves, expected "
            f"{len(leaves)} (config drift?)")
    restored = []
    for key, leaf in zip(keys, leaves):
        arr = data[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"leaf {key}: shape {arr.shape} != expected "
                f"{tuple(leaf.shape)}")
        restored.append(torch.from_numpy(np.array(arr)))
    return tree_unflatten(like, restored)


def _content_digest(cfg: SNNConfig, groups: Dict[str, Dict[str, np.ndarray]],
                    quant_bits: Optional[int] = None) -> str:
    """The reference's digest, byte for byte (``repr(cfg)`` of both
    packages' SNNConfig is the same string)."""
    h = hashlib.sha256(b"repro-registry-v1|")
    h.update(repr(cfg).encode())
    if quant_bits is not None:
        h.update(f"|bits={quant_bits}|".encode())
    for group in sorted(groups):
        h.update(f"|{group}|".encode())
        arrays = groups[group]
        for key in sorted(arrays):
            a = np.ascontiguousarray(arrays[key])
            h.update(key.encode())
            h.update(str(a.shape).encode())
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Records.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """Immutable metadata for one published version (manifest mirror)."""

    name: str
    version: int
    digest: str
    created_at: float
    cfg: SNNConfig
    has_masks: bool
    has_lsq: bool
    quant_bits: int               # LSQ bit width (meaningful when has_lsq)
    assignment: Any               # backend name or {layer: backend}
    plan_digest: Optional[str]    # the publisher's plan (either package's)
    metrics: Dict[str, Any]
    path: str

    @property
    def spec(self) -> str:
        return f"{self.name}@{self.version}"


@dataclasses.dataclass(frozen=True)
class LoadedModel:
    """A fully materialized registry version (CPU tensors), ready to bind
    or serve."""

    params: Any
    masks: Optional[Any]
    lsq_scales: Optional[Any]
    cfg: SNNConfig
    version: ModelVersion


# ---------------------------------------------------------------------------
# The registry.
# ---------------------------------------------------------------------------

class ModelRegistry:
    """Directory-backed versioned model store with named aliases.

    All writes are atomic (tmp dir/file + ``os.replace``): a publisher
    killed mid-write never leaves a half-written version.  In-process
    access is thread-safe; cross-process publishing relies on the atomic
    renames (last alias write wins).  ``device`` is where :meth:`publish`
    compiles a version's plan: the card unless ``device="cpu"``.
    """

    def __init__(self, root: Optional[str] = None, *, device=None):
        self.root = pathlib.Path(root).expanduser() if root else _default_dir()
        self.root.mkdir(parents=True, exist_ok=True)
        self.device = device
        self._lock = threading.RLock()

    # -- paths --------------------------------------------------------------

    def _model_dir(self, name: str) -> pathlib.Path:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid model name {name!r}")
        return self.root / name

    def _version_dir(self, name: str, version: int) -> pathlib.Path:
        return self._model_dir(name) / f"v{version:04d}"

    # -- enumeration --------------------------------------------------------

    def models(self) -> List[str]:
        return sorted(p.name for p in self.root.iterdir()
                      if p.is_dir() and _NAME_RE.match(p.name))

    def versions(self, name: str) -> List[int]:
        mdir = self._model_dir(name)
        if not mdir.exists():
            return []
        out = []
        for p in mdir.iterdir():
            m = _VERSION_RE.match(p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self, name: str) -> Optional[int]:
        vs = self.versions(name)
        return vs[-1] if vs else None

    # -- aliases ------------------------------------------------------------

    def aliases(self, name: str) -> Dict[str, int]:
        path = self._model_dir(name) / "aliases.json"
        if not path.exists():
            return {}
        try:
            return {str(k): int(v) for k, v in
                    json.loads(path.read_text()).items()}
        except (ValueError, TypeError, AttributeError):  # corrupt: empty
            return {}

    def set_alias(self, name: str, alias: str, version: int) -> None:
        # numeric and v<digits> forms are version references in resolve();
        # allowing them as aliases would silently shadow real versions
        if (not _NAME_RE.match(alias) or alias.isdigit()
                or re.fullmatch(r"v\d+", alias)):
            raise ValueError(f"invalid alias {alias!r}")
        with self._lock:
            if version not in self.versions(name):
                raise KeyError(f"{name} has no version {version}")
            amap = self.aliases(name)
            amap[alias] = int(version)
            self._write_aliases(name, amap)

    def drop_alias(self, name: str, alias: str) -> None:
        with self._lock:
            amap = self.aliases(name)
            amap.pop(alias, None)
            self._write_aliases(name, amap)

    def _write_aliases(self, name: str, amap: Dict[str, int]) -> None:
        mdir = self._model_dir(name)
        mdir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=mdir, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(amap, f, indent=1)
        os.replace(tmp, mdir / "aliases.json")

    # -- resolve ------------------------------------------------------------

    def resolve(self, spec: str) -> Tuple[str, int]:
        """``name[@version|@alias]`` -> (name, version).

        A bare ``name`` resolves through the ``production`` alias when set,
        else to the latest version.
        """
        name, _, ref = spec.partition("@")
        if not ref:
            amap = self.aliases(name)
            if "production" in amap:
                return name, amap["production"]
            latest = self.latest(name)
            if latest is None:
                raise KeyError(f"registry has no versions of {name!r}")
            return name, latest
        if ref.lstrip("v").isdigit():
            version = int(ref.lstrip("v"))
        else:
            amap = self.aliases(name)
            if ref not in amap:
                raise KeyError(
                    f"{name!r} has no alias {ref!r} (aliases: "
                    f"{sorted(amap) or 'none'})")
            version = amap[ref]
        if version not in self.versions(name):
            raise KeyError(f"{name} has no version {version}")
        return name, version

    # -- publish ------------------------------------------------------------

    def publish(
        self,
        name: str,
        params,
        cfg: SNNConfig,
        *,
        masks=None,
        lsq_scales=None,
        quant_bits: int = 16,
        assignment: Any = "goap",
        metrics: Optional[Dict[str, Any]] = None,
        alias: Optional[str] = None,
        compile_plan_artifacts: bool = True,
    ) -> ModelVersion:
        """Publish one model version; idempotent on identical content.

        ``assignment`` is the backend (or per-layer map) recorded for
        serving; with ``compile_plan_artifacts`` the version's plan is
        compiled through the default plan cache on the registry's device:
        its digest lands in the manifest and the artifacts on the cache's
        disk tier, so the serving node's hot-swap bind is a cache hit.
        """
        groups = {"params": _flatten_group("params", params)}
        if masks is not None:
            groups["masks"] = _flatten_group("masks", masks)
        if lsq_scales is not None:
            groups["lsq"] = _flatten_group("lsq", lsq_scales)
        digest = _content_digest(cfg, groups,
                                 quant_bits if lsq_scales is not None
                                 else None)

        # the plan compile and the array serialization happen before the
        # registry lock: concurrent publishes, alias flips and resolves
        # wait only on the version allocation, the manifest and the rename
        plan_digest = None
        if compile_plan_artifacts:
            plan_digest = self._compile_plan_digest(
                params, cfg, masks, lsq_scales, quant_bits, assignment)

        mdir = self._model_dir(name)
        mdir.mkdir(parents=True, exist_ok=True)
        tmp = pathlib.Path(tempfile.mkdtemp(dir=mdir, prefix=".tmp-pub-"))
        try:
            arrays = {k: v for g in groups.values() for k, v in g.items()}
            np.savez(tmp / "arrays.npz", **arrays)

            with self._lock:
                existing = self.find_digest(name, digest)
                if existing is not None:
                    if alias:
                        self.set_alias(name, alias, existing.version)
                    return existing
                version = (self.latest(name) or 0) + 1

                manifest = {
                    "format": _FORMAT,
                    "name": name,
                    "version": version,
                    "digest": digest,
                    "created_at": time.time(),
                    "cfg": _cfg_to_json(cfg),
                    "has_masks": masks is not None,
                    "has_lsq": lsq_scales is not None,
                    "quant_bits": int(quant_bits),
                    "assignment": assignment,
                    "plan_digest": plan_digest,
                    "metrics": dict(metrics or {}),
                }
                (tmp / "manifest.json").write_text(json.dumps(manifest,
                                                              indent=1))
                final = self._version_dir(name, version)
                os.replace(tmp, final)  # atomic publish
                if alias:
                    self.set_alias(name, alias, version)
                return self._version_from_manifest(manifest, final)
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)

    def _compile_plan_digest(self, params, cfg, masks, lsq_scales, quant_bits,
                             assignment) -> Optional[str]:
        """Compile the version's port plan (warming the default cache).

        A backend that cannot bind here leaves the manifest without a
        digest, as in the reference, except a kernel backend on the card:
        its failure propagates.
        """
        from repro_torch.fixed import serving_quant_fn
        from repro_torch.models.graph import compile_snn
        from repro_torch.plan import compile_plan
        from repro_torch.serve.autotune import _KERNEL_BACKENDS

        # a kernel backend that fails to compile on the card propagates
        kernels = (assignment in _KERNEL_BACKENDS if isinstance(assignment, str)
                   else any(b in _KERNEL_BACKENDS
                            for b in dict(assignment).values()))
        try:
            dev = resolve_device(self.device)
        except RuntimeError:   # no card here: nothing to compile for
            return None
        try:
            # the serve engines' rule (serving_quant_fn), so the prewarmed
            # digest is what a bind_version of this version compiles
            quant_fn = serving_quant_fn(lsq_scales, quant_bits,
                                        assignment=assignment)
            return compile_plan(compile_snn(cfg), params, masks=masks,
                                quant_fn=quant_fn, assignment=assignment,
                                device=dev).digest
        except Exception:  # noqa: BLE001 — publish even when this host
            # cannot bind the assignment; the manifest just lacks the digest
            if kernels and dev.type == "cuda":
                raise
            return None

    def find_digest(self, name: str, digest: str) -> Optional[ModelVersion]:
        for v in reversed(self.versions(name)):
            mv = self.describe(name, v)
            if mv.digest == digest:
                return mv
        return None

    # -- load ---------------------------------------------------------------

    def describe(self, name: str, version: int) -> ModelVersion:
        vdir = self._version_dir(name, version)
        manifest = json.loads((vdir / "manifest.json").read_text())
        return self._version_from_manifest(manifest, vdir)

    @staticmethod
    def _version_from_manifest(manifest: Dict[str, Any],
                               vdir: pathlib.Path) -> ModelVersion:
        assignment = manifest["assignment"]
        if isinstance(assignment, dict):
            assignment = dict(assignment)
        return ModelVersion(
            name=manifest["name"], version=int(manifest["version"]),
            digest=manifest["digest"], created_at=manifest["created_at"],
            cfg=_cfg_from_json(manifest["cfg"]),
            has_masks=bool(manifest["has_masks"]),
            has_lsq=bool(manifest["has_lsq"]),
            quant_bits=int(manifest.get("quant_bits", 16)),
            assignment=assignment,
            plan_digest=manifest.get("plan_digest"),
            metrics=dict(manifest.get("metrics", {})),
            path=str(vdir))

    def load(self, spec: str) -> LoadedModel:
        """Materialize ``name[@version|@alias]`` into CPU tensor trees.

        Tree structures are rebuilt from the version's own config (the
        registry stores flat leaves), so a load never mixes a new structure
        with old bytes: shape drift raises.
        """
        from repro_torch.train.lsq import init_lsq_scales

        name, version = self.resolve(spec)
        mv = self.describe(name, version)
        with np.load(pathlib.Path(mv.path) / "arrays.npz") as data:
            like_params = init_snn(0, mv.cfg)
            params = _unflatten_group("params", data, like_params)
            masks = None
            if mv.has_masks:
                like_masks = {g: [layer["w"] for layer in like_params[g]]
                              for g in ("conv", "fc")}
                masks = _unflatten_group("masks", data, like_masks)
            lsq = None
            if mv.has_lsq:
                lsq = _unflatten_group("lsq", data,
                                       init_lsq_scales(like_params))
        return LoadedModel(params=params, masks=masks, lsq_scales=lsq,
                           cfg=mv.cfg, version=mv)


# ---------------------------------------------------------------------------
# Checkpoint bridge.
# ---------------------------------------------------------------------------

def publish_from_trainer(registry: ModelRegistry, name: str, trainer, *,
                         assignment: Any = "goap",
                         metrics: Optional[Dict[str, Any]] = None,
                         alias: Optional[str] = None) -> ModelVersion:
    """Publish a live :class:`~repro_torch.train.trainer.SNNTrainer`'s state."""
    m = {"source_step": trainer.step, **(metrics or {})}
    return registry.publish(
        name, trainer.params, trainer.model_cfg, masks=trainer.masks,
        lsq_scales=trainer.lsq_scales, quant_bits=trainer.cfg.quant_bits,
        assignment=assignment, metrics=m, alias=alias)


def publish_from_checkpoint(
    registry: ModelRegistry,
    name: str,
    model_cfg: SNNConfig,
    trainer_cfg=None,
    *,
    ckpt_dir: Optional[str] = None,
    step: Optional[int] = None,
    assignment: Any = "goap",
    metrics: Optional[Dict[str, Any]] = None,
    alias: Optional[str] = None,
) -> ModelVersion:
    """Restore a trainer checkpoint and publish it as a registry version.

    ``trainer_cfg`` must match the run that wrote the checkpoint (it
    shapes the masks/LSQ state trees); ``ckpt_dir`` overrides its
    checkpoint directory; ``step`` picks a checkpoint (default: latest).
    The checkpoint is restored on the registry's device.
    """
    from repro_torch.train.trainer import SNNTrainer, TrainerConfig

    tcfg = trainer_cfg if trainer_cfg is not None else TrainerConfig()
    if ckpt_dir is not None:
        tcfg = dataclasses.replace(tcfg, ckpt_dir=ckpt_dir)
    if tcfg.ckpt_dir is None:
        raise ValueError("no checkpoint directory: pass ckpt_dir= or a "
                         "trainer_cfg with ckpt_dir set")
    trainer = SNNTrainer(model_cfg, tcfg, device=registry.device)
    if not trainer.resume(step=step):
        raise FileNotFoundError(f"no checkpoint under {tcfg.ckpt_dir}")
    manifest = trainer.ckpt.read_manifest(trainer.step)
    m = {"checkpoint_dir": str(tcfg.ckpt_dir),
         **manifest.get("extra", {}), **(metrics or {})}
    return publish_from_trainer(registry, name, trainer,
                                assignment=assignment, metrics=m,
                                alias=alias)
