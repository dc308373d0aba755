"""Declarative SNN layer graph with pluggable execution backends.

Port of ``repro/models/graph.py``.  ``build_layer_graph(cfg)`` derives the
:class:`LayerSpec` nodes; backends register per layer kind and return
per-timestep :class:`LayerCell` objects; :class:`BoundProgram` runs the
cells layer by layer, and :mod:`repro_torch.plan.streaming` threads them
through one loop over timesteps.

Backends and their names in the reference:

============  ============  ===============================================
port          reference     per-layer implementation
============  ============  ===============================================
dense         dense         im2col matmul oracle (plain torch)
goap          goap          packed COO gather + contraction (plain torch)
cuda          pallas        block-sparse conv kernel, weight-masked FC
                            kernel and fused LIF kernel (``kernels/``)
cuda_fused    pallas_fused  the ``cuda`` cells, plus the operands of the
                            whole-network streaming kernel
                            (``kernels/stream_fused.py``)
stream        stream        the Algorithm-2 schedule interpreter with the
                            Tables I/III counters (plain torch,
                            ``core/saocds.py``)
fixed         fixed         integer datapath of the FPGA (``fixed/``,
                            registered on first use)
============  ============  ===============================================

Factories take ``quant_fn``: a weight transform (LSQ fake-quantization,
or the fixed tier's :class:`~repro_torch.fixed.FixedQuantFn`) applied to
the masked weight before any artifact is derived from it.

Dtypes follow the reference's at every point.  With bf16 weights
(``init_snn(..., dtype=torch.bfloat16)``) the ``dense`` conv and every FC
run in the weights' dtype (a product taken in f32 and rounded once,
:func:`~repro_torch.core.goap.matmul_rounded`; the LIF and the readout
round each op to bf16); the ``goap``, ``cuda`` and ``stream`` convs keep
f32 currents and state, which the bf16 LIF parameters promote to; the
``cuda`` FC runs the kernels' bf16 forms.  An effective weight keeps the
dtype of ``w * mask``: an f32 mask (``make_mask_pytree``'s) promotes a
bf16 weight to f32, as in the reference.  ``cuda_fused``'s whole-network
kernel is f32 and casts its operands, so it serves f32 logits.

Unlike the reference, which writes cells for one sample and ``vmap``s
them, every per-timestep value here carries a leading batch axis: a conv
cell steps ``(B, IC, W) -> (B, OC, W)``, an FC cell ``(B, IN) -> ((B, OUT)
spikes, (B, OUT) currents)``.  Sequences are ``(T, B, ...)``.  Cells bind
to one device; the kernel cells launch their kernels on a CUDA device and
run the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.goap import (conv1d_dense_oracle, goap_conv_packed,
                                   goap_pack, matmul_rounded)
from repro_torch.core.lif import LIFParams, lif_step
from repro_torch.core.saocds import make_schedule_step, max_pool_spikes, pad_same
from repro_torch.core.sparse_format import (
    CooKernel,
    block_sparse_from_dense,
    build_schedule,
    coo_from_dense,
    coo_to_dense,
)
from repro_torch.device import resolve_device
from repro_torch.models.snn import SNNConfig

__all__ = [
    "LayerSpec",
    "Conv1dLIF",
    "MaxPool",
    "FCLIF",
    "Readout",
    "build_layer_graph",
    "register_backend",
    "available_backends",
    "get_backend",
    "LayerCell",
    "timestep_template",
    "run_cell",
    "artifact_build_count",
    "SNNProgram",
    "BoundProgram",
    "compile_snn",
    "stream_totals",
]

KIND_CONV = "conv_lif"
KIND_POOL = "maxpool"
KIND_FC = "fc_lif"
KIND_READOUT = "readout"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One node of the layer graph (pure metadata, no parameters)."""

    kind: str
    name: str
    index: int = 0        # position within its param group (conv i / fc i)
    kw: int = 0
    ic: int = 0
    oc: int = 0
    pool: int = 0
    din: int = 0
    dout: int = 0
    mode: str = ""


def Conv1dLIF(index: int, kw: int, ic: int, oc: int, name: str = "") -> LayerSpec:
    return LayerSpec(kind=KIND_CONV, name=name or f"conv{index + 1}",
                     index=index, kw=kw, ic=ic, oc=oc)


def MaxPool(pool: int, name: str = "") -> LayerSpec:
    return LayerSpec(kind=KIND_POOL, name=name or "pool", pool=pool)


def FCLIF(index: int, din: int, dout: int, name: str = "") -> LayerSpec:
    return LayerSpec(kind=KIND_FC, name=name or f"fc{index + 1}",
                     index=index, din=din, dout=dout)


def Readout(mode: str) -> LayerSpec:
    return LayerSpec(kind=KIND_READOUT, name="readout", mode=mode)


def validate_unique_names(specs) -> None:
    """Weighted-layer names key counters and assignments: no duplicates."""
    seen: Dict[str, str] = {}
    for s in specs:
        if s.kind not in (KIND_CONV, KIND_FC):
            continue
        if s.name in seen:
            raise ValueError(f"duplicate layer name {s.name!r} "
                             f"({seen[s.name]} and {s.kind})")
        seen[s.name] = s.kind


def build_layer_graph(cfg: SNNConfig) -> Tuple[LayerSpec, ...]:
    """Derive the declarative layer graph from an ``SNNConfig``."""
    cfg.validate()
    layers: List[LayerSpec] = []
    for i, (kw, ic, oc) in enumerate(cfg.conv_specs):
        layers.append(Conv1dLIF(i, kw, ic, oc))
        layers.append(MaxPool(cfg.pool, name=f"pool{i + 1}"))
    for i, (din, dout) in enumerate(cfg.fc_specs):
        layers.append(FCLIF(i, din, dout))
    layers.append(Readout(cfg.readout))
    validate_unique_names(layers)
    return tuple(layers)


# ---------------------------------------------------------------------------
# The cell protocol.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerCell:
    """Per-timestep execution of one layer.

    * ``init_state(x_t)`` — the carried state for a first input ``x_t``;
    * ``step(state, x_t) -> (state, y_t)`` — advance one timestep;
    * ``finalize(state)`` — optional terminal value (readout logits);
    * ``seq(xs) -> ys`` — optional whole-sequence path for the
      layer-by-layer executor, equal to stepping (cells without finalize);
    * ``fused`` — the layer's operands for the whole-network kernel.
    """

    init_state: Callable[[Any], Any]
    step: Callable[[Any, Any], Tuple[Any, Any]]
    finalize: Optional[Callable[[Any], Any]] = None
    seq: Optional[Callable[[Any], Any]] = None
    fused: Any = None


def _stack_steps(ys: List[Any]):
    if isinstance(ys[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*ys))
    return torch.stack(ys)


def _at(xs, t: int):
    return tuple(x[t] for x in xs) if isinstance(xs, tuple) else xs[t]


def timestep_template(xs):
    """A per-timestep value of a (T, ...) sequence (or a tuple of them)
    with its shape and dtype: what ``init_state`` builds the state from
    (the reference's ``ShapeDtypeStruct``; eager torch takes zeros)."""
    if isinstance(xs, tuple):
        return tuple(torch.zeros_like(x[0]) for x in xs)
    return torch.zeros_like(xs[0])


def run_cell(cell: LayerCell, xs):
    """Drive one cell over a (T, B, ...) sequence: ``(ys, state, aux)``."""
    if cell.seq is not None:
        return cell.seq(xs), None, None
    n_t = xs[0].shape[0] if isinstance(xs, tuple) else xs.shape[0]
    state = cell.init_state(timestep_template(xs))
    ys = []
    for t in range(n_t):
        state, y = cell.step(state, _at(xs, t))
        ys.append(y)
    aux = cell.finalize(state) if cell.finalize is not None else None
    return _stack_steps(ys), state, aux


def _at_batch(xs, b: int):
    """Sample ``b`` of a (T, B, ...) sequence (or a tuple of them)."""
    return tuple(x[:, b] for x in xs) if isinstance(xs, tuple) else xs[:, b]


def _spikes_of(x_t):
    """Input spikes of a per-timestep value (FC cells emit (spikes, currents))."""
    return x_t[0] if isinstance(x_t, tuple) else x_t


# ---------------------------------------------------------------------------
# Backend registry.
# ---------------------------------------------------------------------------

# A factory takes (spec, layer_params, *, cfg, mask, quant_fn, artifacts,
# device) and returns the layer's LayerCell.
BackendFactory = Callable[..., LayerCell]
COMMON = "common"
_REGISTRY: Dict[Tuple[str, str], BackendFactory] = {}

# Backends in optional subpackages register on first use.
_LAZY_BACKENDS: Dict[str, str] = {"fixed": "repro_torch.fixed.backend"}


def _ensure_registered(name: Optional[str] = None) -> None:
    import importlib

    for lazy, module in _LAZY_BACKENDS.items():
        if (name is None or name == lazy) and not any(
                n == lazy for n, _ in _REGISTRY):
            importlib.import_module(module)


def register_backend(name: str, layer_kind: str, fn: BackendFactory) -> BackendFactory:
    _REGISTRY[(name, layer_kind)] = fn
    return fn


def available_backends() -> Tuple[str, ...]:
    _ensure_registered()
    return tuple(sorted({n for n, _ in _REGISTRY if n != COMMON}))


def get_backend(name: str, layer_kind: str) -> BackendFactory:
    """Resolve ``(name, layer_kind)``, falling back to the common pool."""
    _ensure_registered(name)
    if name not in {n for n, _ in _REGISTRY}:
        raise ValueError(f"unknown backend {name!r}; registered backends: "
                         f"{list(available_backends())}")
    fn = _REGISTRY.get((name, layer_kind)) or _REGISTRY.get((COMMON, layer_kind))
    if fn is None:
        raise ValueError(f"backend {name!r} has no implementation for layer "
                         f"kind {layer_kind!r}")
    return fn


# ---------------------------------------------------------------------------
# Bind-time artifacts (derived once per weight set; the plan cache keeps them).
# ---------------------------------------------------------------------------

ARTIFACT_BUILDS: collections.Counter = collections.Counter()


def artifact_build_count() -> int:
    """Total expensive artifact derivations since process start."""
    return sum(ARTIFACT_BUILDS.values())


def _artifact(artifacts: Optional[dict], key: str, build: Callable[[], Any]):
    if artifacts is not None and artifacts.get(key) is not None:
        return artifacts[key]
    ARTIFACT_BUILDS[key] += 1
    val = build()
    if artifacts is not None:
        artifacts[key] = val
    return val


def effective_weight(layer_params, mask, quant_fn=None) -> torch.Tensor:
    """Masked (pruned zeros kept in the matrix), then quantized weight."""
    w = layer_params["w"]
    if mask is not None:
        w = w * mask
    if quant_fn is not None:
        w = quant_fn(w)
    return w


def weight_values(w) -> np.ndarray:
    """A weight's values as float32 numpy (exact for bf16, which numpy
    cannot hold): what the artifacts (COO, schedules, tilings) derive from."""
    return torch.as_tensor(w).detach().to("cpu", torch.float32).numpy()


def _weight_np(layer_params, mask, quant_fn, artifacts) -> np.ndarray:
    if artifacts is not None and artifacts.get("w_eff") is not None:
        return artifacts["w_eff"]
    return weight_values(effective_weight(layer_params, mask, quant_fn))


def _weight(layer_params, mask, quant_fn, artifacts, device) -> torch.Tensor:
    """The effective weight on ``device`` in its dtype: a plan's
    precomputed one (float32 values and the dtype they came in), else (an
    unbound ``SNNProgram._bind``) the tensor itself, so autograd reaches
    the weight, its mask product and the quant_fn's step size."""
    if artifacts is not None and artifacts.get("w_eff") is not None:
        dtype = getattr(torch, artifacts.get("w_dtype") or "float32")
        return torch.as_tensor(artifacts["w_eff"], dtype=torch.float32,
                               device=device).to(dtype)
    return effective_weight(layer_params, mask, quant_fn).to(device=device)


def _layer_coo(layer_params, mask, quant_fn, artifacts) -> CooKernel:
    if "coo" in layer_params:
        return layer_params["coo"]
    return _artifact(artifacts, "coo", lambda: coo_from_dense(
        _weight_np(layer_params, mask, quant_fn, artifacts)))


# ---------------------------------------------------------------------------
# Common cells.
# ---------------------------------------------------------------------------

def _common_maxpool(spec, layer_params, *, cfg, mask=None, quant_fn=None,
                    artifacts=None, device=None) -> LayerCell:
    return LayerCell(init_state=lambda x_t: (),
                     step=lambda state, x_t: (state, max_pool_spikes(x_t, spec.pool)),
                     seq=lambda xs: max_pool_spikes(xs, spec.pool))


def _common_readout(spec, layer_params, *, cfg, mask=None, quant_fn=None,
                    artifacts=None, device=None) -> LayerCell:
    use_current = spec.mode == "current_sum"

    def init_state(x_t):
        return torch.zeros_like(x_t[1] if use_current else x_t[0])

    def step(acc, x_t):
        spikes_t, currents_t = x_t
        return acc + (currents_t if use_current else spikes_t), spikes_t

    return LayerCell(init_state=init_state, step=step, finalize=lambda acc: acc)


register_backend(COMMON, KIND_POOL, _common_maxpool)
register_backend(COMMON, KIND_READOUT, _common_readout)


# ---------------------------------------------------------------------------
# Conv/FC cell builders shared by the backends.
# ---------------------------------------------------------------------------

def _conv_cell(kw: int, oc: int, lif: LIFParams, current_fn,
               dtype: torch.dtype) -> LayerCell:
    """LIF conv cell with its membrane in ``dtype`` (the reference's: the
    weights' for ``dense``, f32 for the sparse convs)."""
    def init_state(x_t):
        return x_t.new_zeros((x_t.shape[0], oc, x_t.shape[-1]), dtype=dtype)

    def step(v, x_t):
        return lif_step(v, current_fn(pad_same(_spikes_of(x_t), kw)), lif)

    return LayerCell(init_state=init_state, step=step)


def _fc_cell(w: torch.Tensor, lif: LIFParams, current_fn=None) -> LayerCell:
    if current_fn is None:
        current_fn = lambda s: matmul_rounded(s.to(w.dtype), w)   # noqa: E731

    def init_state(x_t):
        return w.new_zeros((_spikes_of(x_t).shape[0], w.shape[1]))

    def step(v, x_t):
        s = _spikes_of(x_t)
        cur = current_fn(s.reshape(s.shape[0], -1))
        v_next, out = lif_step(v, cur, lif)
        return v_next, (out, cur)

    return LayerCell(init_state=init_state, step=step)


# ---------------------------------------------------------------------------
# dense and goap backends (plain torch).
# ---------------------------------------------------------------------------

def _dense_conv(spec, layer_params, *, cfg, mask=None, quant_fn=None,
                artifacts=None, device=None) -> LayerCell:
    w = _weight(layer_params, mask, quant_fn, artifacts, device)
    return _conv_cell(spec.kw, spec.oc, layer_params["lif"].to(device),
                      lambda ifm: conv1d_dense_oracle(ifm, w), w.dtype)


def _dense_fc(spec, layer_params, *, cfg, mask=None, quant_fn=None,
              artifacts=None, device=None) -> LayerCell:
    return _fc_cell(_weight(layer_params, mask, quant_fn, artifacts, device),
                    layer_params["lif"].to(device))


def _goap_conv(spec, layer_params, *, cfg, mask=None, quant_fn=None,
               artifacts=None, device=None) -> LayerCell:
    coo = _layer_coo(layer_params, mask, quant_fn, artifacts)
    if artifacts is not None and artifacts.get("goap_pack") is not None:
        pack = artifacts["goap_pack"]
    else:
        pack = goap_pack(coo)
        if artifacts is not None:
            artifacts["goap_pack"] = pack
    pack = pack.to(device)
    return _conv_cell(coo.kw, coo.oc, layer_params["lif"].to(device),
                      lambda ifm: goap_conv_packed(ifm, pack), torch.float32)


register_backend("dense", KIND_CONV, _dense_conv)
register_backend("dense", KIND_FC, _dense_fc)
register_backend("goap", KIND_CONV, _goap_conv)
# FC layers use the weight-mask method: the zeros kept in the matrix are
# the mask, so the dense FC cell is numerically the WM cell.
register_backend("goap", KIND_FC, _dense_fc)


# ---------------------------------------------------------------------------
# cuda backend — the per-layer kernels (port of the reference's ``pallas``).
# ---------------------------------------------------------------------------

BLOCK_OC = 8
BLOCK_K = 32


def _cuda_conv(spec, layer_params, *, cfg, mask=None, quant_fn=None,
               artifacts=None, device=None) -> LayerCell:
    from repro_torch.kernels.ops import (block_sparse_to, goap_conv_op, lif_op,
                                         lif_operands)

    def build_bs():
        if "coo" in layer_params:
            w = coo_to_dense(layer_params["coo"]).astype(np.float32)
        else:
            w = _weight_np(layer_params, mask, quant_fn, artifacts)
        return block_sparse_from_dense(w, block_oc=BLOCK_OC, block_k=BLOCK_K)

    bs = block_sparse_to(_artifact(artifacts, "block_sparse", build_bs), device)
    lif = layer_params["lif"].to(device)
    cell = _conv_cell(bs.kw, bs.oc, lif, lambda ifm: goap_conv_op(ifm, bs),
                      torch.float32)
    # the LIF's operands once, for the f32 membrane goap_conv_op gives
    with torch.no_grad():
        lif_ops = lif_operands(lif, torch.float32)

    def seq(xs):
        # conv currents depend only on this timestep's input: the whole
        # (T, B) sequence is one conv launch, then one LIF launch over T
        currents = goap_conv_op(pad_same(xs, bs.kw), bs)
        return lif_op(currents, lif_ops)[0]

    return dataclasses.replace(cell, seq=seq)


def _cuda_fc(spec, layer_params, *, cfg, mask=None, quant_fn=None,
             artifacts=None, device=None) -> LayerCell:
    from repro_torch.kernels.ops import lif_op, lif_operands, wm_fc_op

    w = _weight(layer_params, mask, quant_fn, artifacts, device)
    lif = layer_params["lif"].to(device)
    cell = _fc_cell(w, lif, current_fn=lambda s: wm_fc_op(s, w))
    # the LIF's operands once, for the membrane in the weights' dtype
    with torch.no_grad():
        lif_ops = lif_operands(lif, w.dtype)

    def seq(xs):
        # FC currents are memoryless in T: one (T*B, IN) WM launch, then
        # one fused LIF launch over T
        x = _spikes_of(xs)
        currents = wm_fc_op(x.reshape(x.shape[0], x.shape[1], -1), w)
        return lif_op(currents, lif_ops)[0], currents

    return dataclasses.replace(cell, seq=seq)


register_backend("cuda", KIND_CONV, _cuda_conv)
register_backend("cuda", KIND_FC, _cuda_fc)


# ---------------------------------------------------------------------------
# cuda_fused backend — cuda cells + operands of the whole-network kernel
# (port of the reference's ``pallas_fused``).
# ---------------------------------------------------------------------------

def _cuda_fused_conv(spec, layer_params, *, cfg, mask=None, quant_fn=None,
                     artifacts=None, device=None) -> LayerCell:
    from repro_torch.kernels.stream_fused import fused_conv_info

    cell = _cuda_conv(spec, layer_params, cfg=cfg, mask=mask,
                      quant_fn=quant_fn, artifacts=artifacts, device=device)
    coo = _layer_coo(layer_params, mask, quant_fn, artifacts)
    sched = _artifact(artifacts, "schedule", lambda: build_schedule(coo))
    return dataclasses.replace(
        cell, fused=fused_conv_info(spec.name, coo, layer_params["lif"], sched))


def _cuda_fused_fc(spec, layer_params, *, cfg, mask=None, quant_fn=None,
                   artifacts=None, device=None) -> LayerCell:
    from repro_torch.kernels.stream_fused import fused_fc_info

    cell = _cuda_fc(spec, layer_params, cfg=cfg, mask=mask,
                    quant_fn=quant_fn, artifacts=artifacts, device=device)
    return dataclasses.replace(cell, fused=fused_fc_info(
        spec.name, _weight_np(layer_params, mask, quant_fn, artifacts),
        layer_params["lif"]))


register_backend("cuda_fused", KIND_CONV, _cuda_fused_conv)
register_backend("cuda_fused", KIND_FC, _cuda_fused_fc)


# ---------------------------------------------------------------------------
# stream backend — Algorithm-2 interpreter with the Tables I/III counters.
# ---------------------------------------------------------------------------

def _stream_conv(spec, layer_params, *, cfg, mask=None, quant_fn=None,
                 artifacts=None, device=None) -> LayerCell:
    coo = _layer_coo(layer_params, mask, quant_fn, artifacts)
    sched = _artifact(artifacts, "schedule", lambda: build_schedule(coo))
    one_timestep = make_schedule_step(sched, layer_params["lif"].to(device),
                                      coo.oc, device=device)
    static_counts = {
        "reps_per_timestep": sched.reps,
        "compute_iters": sched.n_compute,
        "extra_iters": sched.n_extra,
        "empty_iters": sched.n_empty,
    }

    def init_state(x_t):
        b, w = x_t.shape[0], x_t.shape[-1]
        return (torch.zeros((b, coo.oc, w), dtype=torch.float32,
                            device=x_t.device),
                torch.zeros((b,), dtype=torch.int64, device=x_t.device), 0)

    def step(carry, x_t):
        v, acc, t = carry
        v, (out, a) = one_timestep(v, pad_same(_spikes_of(x_t), coo.kw))
        return (v, acc + a, t + 1), out

    def finalize(carry):
        # int64 on the device, float32 out as in the reference (exact
        # below 2**24 events a frame)
        _, acc, t = carry
        return {**static_counts, "accumulations": acc.to(torch.float32),
                "timesteps": t}

    return LayerCell(init_state=init_state, step=step, finalize=finalize)


register_backend("stream", KIND_CONV, _stream_conv)
register_backend("stream", KIND_FC, _dense_fc)  # WM method, see goap above


def stream_totals(counters: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate per-layer stream counters into whole-network totals."""
    totals = {"compute_iters": 0, "extra_iters": 0, "empty_iters": 0,
              "reps_per_timestep": 0, "accumulations": 0.0}
    for counts in counters.values():
        totals["compute_iters"] += counts["compute_iters"]
        totals["extra_iters"] += counts["extra_iters"]
        totals["empty_iters"] += counts["empty_iters"]
        totals["reps_per_timestep"] += counts["reps_per_timestep"]
        totals["accumulations"] = totals["accumulations"] + counts["accumulations"]
    return totals


# ---------------------------------------------------------------------------
# The compiled program.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BoundProgram:
    """A layer graph bound to parameters: one cell per layer, run layer by
    layer (every cell over the whole sequence in turn)."""

    backend: str
    stages: Tuple[Tuple[LayerSpec, LayerCell], ...]

    def run_batch(self, xs: torch.Tensor):
        """(T, B, IC0, W) -> ((B, n_classes) logits, counters)."""
        x = xs
        logits = None
        counters: Dict[str, Dict] = {}
        for spec, cell in self.stages:
            ys, _, aux = run_cell(cell, x)
            if spec.kind == KIND_READOUT:
                logits = aux
            elif aux is not None:
                counters[spec.name] = aux
            x = ys
        return (logits if logits is not None else x), counters

    def run(self, frames: torch.Tensor):
        """(T, IC0, W) frames -> (logits (n_classes,), counters); a slice
        of the graph without the readout returns its last layer's (T, ...)
        outputs instead of logits."""
        out, counters = self.run_batch(frames[:, None])
        if any(spec.kind == KIND_READOUT for spec, _ in self.stages):
            return out[0], counters
        return _at_batch(out, 0), counters

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        """(T, IC0, W) frames -> logits (n_classes,)."""
        return self.run(frames)[0]

    def batch(self, frames_b: torch.Tensor) -> torch.Tensor:
        """(B, T, IC0, W) -> (B, n_classes)."""
        return self.run_batch(frames_b.transpose(0, 1))[0]


@dataclasses.dataclass(frozen=True)
class SNNProgram:
    """An ``SNNConfig`` compiled into an executable layer graph."""

    cfg: SNNConfig
    layers: Tuple[LayerSpec, ...]

    @classmethod
    def from_config(cls, cfg: SNNConfig) -> "SNNProgram":
        return cls(cfg=cfg, layers=build_layer_graph(cfg))

    def apply(self, params, frames, backend: str = "dense", *, masks=None,
              quant_fn=None, return_counters: bool = False, device=None):
        """One sample (T, IC0, W) -> logits (n_classes,), through a cached
        plan on ``device`` (the card unless ``device="cpu"``).

        With ``return_counters=True`` also returns the per-conv-layer
        counters (the ``stream`` and ``cuda_fused`` backends carry the
        Tables I/III quantities; the others none)."""
        from repro_torch.plan import compile_plan

        plan = compile_plan(self, params, masks=masks, quant_fn=quant_fn,
                            assignment=backend, device=device)
        logits, counters = plan.run_layered(plan.to_device(frames))
        return (logits, counters) if return_counters else logits

    def apply_batch(self, params, frames_b, backend: str = "dense", *,
                    masks=None, quant_fn=None, device=None) -> torch.Tensor:
        """(B, T, IC0, W) -> (B, n_classes)."""
        from repro_torch.plan import compile_plan

        plan = compile_plan(self, params, masks=masks, quant_fn=quant_fn,
                            assignment=backend, device=device)
        return plan.bound.batch(plan.to_device(frames_b))

    def run_layers(self, layers, params, x: torch.Tensor,
                   backend: str = "dense", *, masks=None, quant_fn=None,
                   device=None):
        """Execute a contiguous slice of the graph on one sample ``x``
        (T, IC, W) (pipeline stages): the slice's (T, ...) outputs, or the
        logits when it ends in the readout."""
        return self._bind(params, backend, masks=masks, quant_fn=quant_fn,
                          device=device, layers=layers).run(x)[0]

    # -- graph slicing (pipeline-stage construction) -------------------------

    def conv_block(self, i: int) -> Tuple[LayerSpec, ...]:
        """The (Conv1dLIF, MaxPool) pair for conv stage ``i``."""
        convs = [j for j, s in enumerate(self.layers) if s.kind == KIND_CONV]
        j = convs[i]
        return self.layers[j:j + 2]

    def head_layers(self) -> Tuple[LayerSpec, ...]:
        """Everything from the first FC layer through the readout."""
        first_fc = next(j for j, s in enumerate(self.layers)
                        if s.kind == KIND_FC)
        return self.layers[first_fc:]

    def _bind(self, params, backend: str = "dense", *, masks=None,
              quant_fn=None, device=None, layers=None) -> BoundProgram:
        """Resolve every layer against ``backend`` and close over params on
        ``device`` (the card unless ``device="cpu"``).

        The raw, uncached binding primitive: no plan, no artifacts.  On
        ``dense`` the cells hold the params' own tensors, so a loss of
        their output differentiates to every weight, LIF parameter and LSQ
        step size (the trainer's path); ``quant_fn`` is called once per
        weighted layer, in graph order.  Concrete-weight serving goes
        through :func:`repro_torch.plan.compile_plan` instead.  ``layers``
        binds a slice of the graph (default: all of it).
        """
        dev = resolve_device(device)
        stages = []
        for spec in (self.layers if layers is None else layers):
            factory = get_backend(backend, spec.kind)
            lp, m = self.layer_params(spec, params, masks)
            stages.append((spec, factory(spec, lp, cfg=self.cfg, mask=m,
                                         quant_fn=quant_fn, device=dev)))
        return BoundProgram(backend=backend, stages=tuple(stages))

    def bind(self, params, backend: str = "dense", *, masks=None,
             quant_fn=None, layers=None, device=None) -> BoundProgram:
        """Deprecated: use :func:`repro_torch.plan.compile_plan` (cached
        artifacts, per-layer assignment, fused streaming) for concrete
        weights, or :meth:`apply` / :meth:`apply_batch`."""
        warnings.warn(
            "SNNProgram.bind is deprecated; use repro_torch.plan.compile_plan "
            "(cached ExecutionPlans, per-layer backend assignment, fused "
            "streaming) or SNNProgram.apply", DeprecationWarning, stacklevel=2)
        return self._bind(params, backend, masks=masks, quant_fn=quant_fn,
                          device=device, layers=layers)

    @staticmethod
    def layer_params(spec: LayerSpec, params, masks):
        if spec.kind == KIND_CONV:
            return params["conv"][spec.index], (
                masks["conv"][spec.index] if masks else None)
        if spec.kind == KIND_FC:
            return params["fc"][spec.index], (
                masks["fc"][spec.index] if masks else None)
        return None, None


@functools.lru_cache(maxsize=None)
def compile_snn(cfg: SNNConfig) -> SNNProgram:
    """Compile (and cache) the layer graph for ``cfg``."""
    return SNNProgram.from_config(cfg)
