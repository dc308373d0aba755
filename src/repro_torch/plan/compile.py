"""Plan compiler: every bind-time artifact derived once, content-hashed.

Port of ``repro/plan/compile.py``.  ``compile_plan(program, params,
masks=..., assignment=..., device=...)`` resolves each layer against its
assigned backend, derives the numpy artifacts (COO kernels, Algorithm-2
schedules, block-sparse tilings, effective weights) and the cost-model
priors, and binds every cell to ``device`` — the card unless
``device="cpu"`` — in an immutable :class:`ExecutionPlan`.  Plans are
hashed on (config, device, per-layer backend, effective weight, mask and
LIF bytes): a second call with the same inputs returns the same plan
object from the cache, and a fresh process reloads the numpy artifacts
from the cache's disk tier instead of rebuilding them.

``assignment`` is one backend name or a ``{layer_name: backend}`` map
(unlisted layers take ``default_backend``).  ``quant_fn`` (LSQ
fake-quantization or the fixed tier's ``FixedQuantFn``) is applied to
every weighted layer's masked weight in graph order, once per compile, so
the digest and every artifact see the quantized weights; pass a fresh
closure per compile (it counts layers).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.sparse_format import coo_to_dense
from repro_torch.device import resolve_device
from repro_torch.models.graph import (
    BLOCK_K,
    BLOCK_OC,
    KIND_CONV,
    KIND_FC,
    BoundProgram,
    LayerCell,
    LayerSpec,
    SNNProgram,
    artifact_build_count,
    effective_weight,
    get_backend,
    validate_unique_names,
    weight_values,
)
from repro_torch.models.snn import SNNConfig
from repro_torch.plan.cache import PlanCache, default_cache

__all__ = ["LayerPlan", "ExecutionPlan", "compile_plan", "artifact_build_count"]

_VERSION = b"repro-torch-plan-v1|"


def _hash_arrays(h, *arrays) -> None:
    for a in arrays:
        a = np.asarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())


def _hash_tensors(h, *tensors) -> None:
    """Hash tensors with their dtype: a bf16 tensor by its 16-bit pattern,
    so a bf16 model and its f32 upcast never share a digest."""
    for t in tensors:
        t = torch.as_tensor(t).detach().cpu()
        if t.dtype == torch.bfloat16:
            h.update(f"{tuple(t.shape)}|bfloat16|".encode())
            h.update(t.contiguous().view(torch.int16).numpy().tobytes())
        else:
            _hash_arrays(h, t.numpy())


def _layer_key(spec: LayerSpec, layer_params, mask,
               w_eff: Optional[np.ndarray], w_dtype: str = "float32") -> str:
    """Artifact key of one layer (no backend, no device: artifacts are
    numpy and shared by every backend of the same weights and dtype)."""
    h = hashlib.sha256(_VERSION)
    h.update(repr(spec).encode())
    if w_eff is not None:
        if w_dtype != "float32":
            h.update(f"w_dtype={w_dtype}|".encode())
        _hash_arrays(h, w_eff)
    else:
        coo = layer_params["coo"]
        h.update(f"coo:{coo.kw}:{coo.ic}:{coo.oc}".encode())
        _hash_arrays(h, coo.data, coo.row_idx, coo.col_idx)
    if mask is not None:
        _hash_tensors(h, mask)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Cost-model priors (the order of the per-layer backend race).
# ---------------------------------------------------------------------------

def _tile_mults(w: np.ndarray, block_oc: int = BLOCK_OC,
                block_k: int = BLOCK_K) -> int:
    """MACs the static block-sparse layout executes per output position."""
    kw, ic, oc = w.shape
    flat = np.transpose(w, (2, 1, 0)).reshape(oc, ic * kw)
    pad_oc = (-flat.shape[0]) % block_oc
    pad_k = (-flat.shape[1]) % block_k
    flat = np.pad(flat, ((0, pad_oc), (0, pad_k)))
    tiles = flat.reshape(flat.shape[0] // block_oc, block_oc,
                         flat.shape[1] // block_k, block_k)
    nonempty = int((np.abs(tiles).sum(axis=(1, 3)) != 0).sum())
    return max(1, nonempty) * block_oc * block_k


def _layer_cost(spec: LayerSpec, backend: str, layer_params, w_eff,
                artifacts: Optional[dict]) -> Dict[str, Any]:
    """Analytic work per output position for each candidate backend
    (relative units): priors, not measurements.  They order the per-layer
    race and are its choice of last resort.  The exact Algorithm-2 reps
    are used only when this compile assigned ``stream`` (which builds the
    schedule); otherwise nnz + OC bounds them, whatever the shared
    artifact cache holds.  The reference's ``pallas`` prior is ``cuda``
    here, with the same value."""
    artifacts = artifacts or {}
    if spec.kind == KIND_CONV:
        total = spec.kw * spec.ic * spec.oc
        dense_w = w_eff
        if dense_w is None and layer_params is not None and "coo" in layer_params:
            dense_w = coo_to_dense(layer_params["coo"])
        coo = artifacts.get("coo")
        if coo is not None:
            nnz = coo.nnz
        elif dense_w is not None:
            nnz = int((np.asarray(dense_w) != 0).sum())
        else:
            return {}
        sched = artifacts.get("schedule") if backend == "stream" else None
        # reps = nnz + extra + empty (paper Table III); without the built
        # schedule, extra iterations are bounded by OC and empties by IC
        reps = sched.reps if sched is not None else nnz + spec.oc
        priors = {"dense": float(total), "goap": float(reps)}
        if dense_w is not None:
            priors["cuda"] = float(_tile_mults(np.asarray(dense_w)))
        return {"nnz": int(nnz), "density": nnz / max(1, total),
                "reps": int(reps), "backend_priors": priors}
    if spec.kind == KIND_FC:
        total = spec.din * spec.dout
        nnz = int((np.asarray(w_eff) != 0).sum()) if w_eff is not None else total
        # the WM method skips work, not slots (paper §V-C.2): every FC
        # backend runs the same matmul shape, so the priors tie at the
        # padded size and the conv layers decide heterogeneous splits
        pad = (-spec.dout) % BLOCK_K
        priors = {"dense": float(total), "goap": float(total),
                  "cuda": float(spec.din * (spec.dout + pad))}
        return {"nnz": nnz, "density": nnz / max(1, total),
                "backend_priors": priors}
    return {}


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer of an ExecutionPlan: spec + assigned backend + live cell,
    and the layer's cost-model priors (empty for unweighted layers)."""

    spec: LayerSpec
    backend: str
    cell: LayerCell
    cost: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """An immutable, fully precomputed execution of one SNN on one device.

    * ``run_streaming(frames)`` — all layers in one loop over timesteps,
      or one launch of the whole-network kernel when every weighted layer
      is ``cuda_fused``;
    * ``run_layered(frames)`` — layer by layer over the same cells;
    * ``batch(frames_b)`` — the batched streaming executor.
    """

    cfg: SNNConfig
    assignment: Dict[str, str]
    digest: str
    layers: Tuple[LayerPlan, ...]
    bound: BoundProgram
    device: torch.device

    def to_device(self, frames) -> torch.Tensor:
        """Frames (tensor or array) as float32 on the plan's device (a
        bf16 model too: its first layer casts, as the reference's does)."""
        return torch.as_tensor(frames, dtype=torch.float32, device=self.device)

    def run_streaming(self, frames: torch.Tensor):
        from repro_torch.plan.streaming import run_streaming

        return run_streaming(self, frames)

    def run_layered(self, frames: torch.Tensor):
        return self.bound.run(frames)

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        return self.run_streaming(frames)[0]

    @functools.cached_property
    def _stack(self):
        from repro_torch.kernels.stream_fused import fused_stack_of

        return fused_stack_of(self)

    def fused_stack(self):
        """Operands of the whole-network kernel, or None (None unless every
        weighted layer is assigned ``cuda_fused``).  Built once per plan, so
        its device operands are packed once."""
        return self._stack

    def batch(self, frames_b: torch.Tensor) -> torch.Tensor:
        """(B, T, IC0, W) -> (B, n_classes) through the fused executor."""
        stack = self.fused_stack()
        if stack is not None:
            from repro_torch.kernels.stream_fused import stream_fused_forward

            return stream_fused_forward(stack, frames_b)[0]
        from repro_torch.plan.streaming import run_streaming_batch

        return run_streaming_batch(self, frames_b.transpose(0, 1))[0]

    def preferred_batch(self):
        """The whole-network kernel when the assignment provides one, else
        the layer-by-layer bound path."""
        return self.batch if self.fused_stack() is not None else self.bound.batch

    @property
    def supports_live_counters(self) -> bool:
        """True when :meth:`batch_counters` reports per-batch gated
        accumulation counts (Table III): every conv layer counts in its
        step, through the whole-network kernel or the ``stream``
        interpreter."""
        if self.fused_stack() is not None:
            return True
        return all(lp.backend == "stream" for lp in self.layers
                   if lp.spec.kind == KIND_CONV)

    def batch_counters(self, frames_b: torch.Tensor):
        """(B, T, IC0, W) -> (logits (B, n_classes), {conv_name: (B,) accs}).

        The counter-returning twin of :meth:`batch`: the whole-network
        kernel's ``conv_accs``, or the ``stream`` interpreter's counters.
        Counts are float32, exact below 2**24 events a frame.  Without
        :attr:`supports_live_counters` the dict holds only the layers
        that count (none for ``goap``, ``dense``, ``cuda``, ``fixed``)."""
        stack = self.fused_stack()
        if stack is not None:
            from repro_torch.kernels.stream_fused import stream_fused_forward

            logits, accs = stream_fused_forward(stack, frames_b)
            return logits, {name: accs[:, i]
                            for i, name in enumerate(stack.conv_names)}
        from repro_torch.plan.streaming import run_streaming_batch

        logits, counters = run_streaming_batch(self, frames_b.transpose(0, 1))
        return logits, {name: c["accumulations"]
                        for name, c in counters.items()
                        if "accumulations" in c}

    def cost_priors(self) -> Dict[str, Dict[str, float]]:
        """Per weighted layer: predicted relative cost per backend."""
        return {lp.spec.name: dict(lp.cost.get("backend_priors", {}))
                for lp in self.layers if lp.cost.get("backend_priors")}

    def summary(self) -> dict:
        return {
            "digest": self.digest,
            "assignment": dict(self.assignment),
            "costs": {lp.spec.name: {k: v for k, v in lp.cost.items()
                                     if k != "backend_priors"}
                      for lp in self.layers if lp.cost},
        }


def _resolve_assignment(specs, assignment: Union[str, Mapping[str, str]],
                        default_backend: str) -> Tuple[Dict[str, str], str]:
    """(per-weighted-layer backend map, backend for common layers)."""
    weighted = {s.name for s in specs if s.kind in (KIND_CONV, KIND_FC)}
    if isinstance(assignment, str):
        return {n: assignment for n in sorted(weighted)}, assignment
    amap = dict(assignment)
    unknown = set(amap) - {s.name for s in specs}
    if unknown:
        raise ValueError(f"assignment names unknown layers {sorted(unknown)}")
    unweighted = set(amap) - weighted
    if unweighted:
        raise ValueError(f"assignment targets non-weighted layers "
                         f"{sorted(unweighted)}; only conv/FC layers take a "
                         "backend")
    return ({n: amap.get(n, default_backend) for n in sorted(weighted)},
            default_backend)


def compile_plan(
    program: SNNProgram,
    params,
    *,
    masks=None,
    assignment: Union[str, Mapping[str, str]] = "dense",
    default_backend: str = "dense",
    cache: Optional[PlanCache] = None,
    device=None,
    quant_fn=None,
) -> ExecutionPlan:
    """Precompute an :class:`ExecutionPlan` on ``device`` (cached by content).

    ``device=None`` means the card, and raises when there is none.
    """
    dev = resolve_device(device)
    cache = cache if cache is not None else default_cache()
    specs = program.layers
    validate_unique_names(specs)
    resolved, common_backend = _resolve_assignment(specs, assignment,
                                                   default_backend)
    for spec in specs:
        get_backend(resolved.get(spec.name, common_backend), spec.kind)

    h = hashlib.sha256(_VERSION)
    h.update(repr(program.cfg).encode())
    h.update(f"|device={dev}|".encode())
    infos = []
    for spec in specs:
        backend = resolved.get(spec.name, common_backend)
        h.update(f"|{spec.name}={backend}|".encode())
        lp, mask = program.layer_params(spec, params, masks)
        w_eff = lkey = None
        w_dtype = "float32"
        if spec.kind in (KIND_CONV, KIND_FC):
            if "coo" not in lp:
                w = effective_weight(lp, mask, quant_fn)
                w_eff = weight_values(w)
                w_dtype = str(w.dtype).removeprefix("torch.")
            lkey = _layer_key(spec, lp, mask, w_eff, w_dtype)
            h.update(lkey.encode())
            lif = lp["lif"]
            _hash_tensors(h, lif.alpha_logit, lif.theta, lif.v_th)
        infos.append((spec, backend, lp, mask, w_eff, w_dtype, lkey))
    digest = h.hexdigest()

    cached = cache.get_plan(digest)
    if cached is not None:
        return cached

    lplans = []
    for spec, backend, lp, mask, w_eff, w_dtype, lkey in infos:
        artifacts: Optional[Dict[str, Any]] = None
        if lkey is not None:
            artifacts = cache.get_artifacts(lkey) or {}
            if w_eff is not None:
                artifacts["w_eff"] = w_eff
                artifacts["w_dtype"] = w_dtype
            before = {k for k, v in artifacts.items() if v is not None}
        cell = get_backend(backend, spec.kind)(
            spec, lp, cfg=program.cfg, mask=mask, quant_fn=quant_fn,
            artifacts=artifacts, device=dev)
        cost = {}
        if lkey is not None:
            cost = _layer_cost(spec, backend, lp, w_eff, artifacts)
            if {k for k, v in artifacts.items() if v is not None} != before:
                cache.put_artifacts(lkey, artifacts)
        lplans.append(LayerPlan(spec=spec, backend=backend, cell=cell,
                                cost=cost))

    label = (assignment if isinstance(assignment, str)
             else "per-layer:" + ",".join(f"{k}={v}" for k, v in
                                          sorted(resolved.items())))
    bound = BoundProgram(backend=label,
                         stages=tuple((lp.spec, lp.cell) for lp in lplans))
    plan = ExecutionPlan(cfg=program.cfg, assignment=resolved, digest=digest,
                         layers=tuple(lplans), bound=bound, device=dev)
    cache.put_plan(digest, plan)
    return plan
