"""Whole-network streaming SNN forward in one CUDA launch.

Replaces the Pallas kernel ``repro/kernels/stream_fused.py::
stream_fused_forward``.  The kernel (``csrc/stream_fused.cu``) runs one
block per sample with a loop over T inside the block; conv weights, every
membrane, the spike buffers and the accumulators stay in shared memory for
all T timesteps, and FC weights are fetched from global memory (L2) only
for the rows of active input spikes.  What bounds it on the H100 is f32
add throughput on the CUDA cores, a few microseconds of work for a batch
of 64; this first version is latency-bound far above that (see PERF.md).

``stream_fused_forward`` launches the kernel for a CUDA tensor and runs
:func:`stream_fused_forward_ref`, the plain PyTorch version, for a CPU
tensor.  The plain version loops over T and the layers and adds every
current in the kernel's order (ascending shift-buffer row, ci-major
``r = ci*IC + ic``, products and sums rounded separately), so on the card
the two agree bit for bit.

The host helpers (``fused_conv_info``, ``fused_fc_info``,
``fused_stack_of``, ``fused_counters``) build the same numpy operands as
the reference.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparse_format import coo_to_dense

__all__ = [
    "FusedConv",
    "FusedFC",
    "FusedPool",
    "FusedReadout",
    "FusedStack",
    "fused_conv_info",
    "fused_fc_info",
    "fused_stack_of",
    "fused_counters",
    "stream_fused_forward",
    "stream_fused_forward_ref",
]

# Layer-kind strings of repro_torch.models.graph.
_KIND_CONV = "conv_lif"
_KIND_POOL = "maxpool"
_KIND_FC = "fc_lif"
_KIND_READOUT = "readout"

# The backend whose cells carry fused operands.
FUSED_BACKEND = "cuda_fused"

# Shared memory a block may use on the H100 (bytes).
MAX_SMEM = 232_448


def _lif_rows(lif, n: int) -> np.ndarray:
    """LIFParams -> (3, n) f32 rows [alpha, theta, v_th], alpha by
    ``torch.sigmoid`` on the host (kernel and plain version share it)."""
    def row(a) -> np.ndarray:
        a = torch.as_tensor(a).detach().to("cpu", torch.float32)
        a = a.reshape(-1).numpy()
        if a.size == 1:
            a = np.full((n,), float(a[0]), dtype=np.float32)
        if a.size != n:
            raise ValueError(f"LIF param size {a.size} != {n} neurons")
        return a

    alpha = torch.sigmoid(torch.as_tensor(lif.alpha_logit).detach()
                          .to("cpu", torch.float32))
    return np.stack([row(alpha), row(lif.theta), row(lif.v_th)])


@dataclasses.dataclass(frozen=True)
class FusedConv:
    """One conv layer's resident operands (ci-major GOAP layout)."""

    name: str
    kw: int
    ic: int
    oc: int
    w_cm: np.ndarray           # (OC, KW*IC) f32; col r = ci*IC + ic
    counts: np.ndarray         # (1, KW*IC) f32; nnz per shift-buffer row
    lif: np.ndarray            # (3, OC) f32: alpha, theta, v_th
    static_counts: Dict[str, int]  # Algorithm-2 reps/compute/extra/empty


@dataclasses.dataclass(frozen=True)
class FusedFC:
    name: str
    w: np.ndarray              # (IN, OUT) f32, zeros = weight mask
    lif: np.ndarray            # (3, OUT) f32


@dataclasses.dataclass(frozen=True)
class FusedPool:
    pool: int


@dataclasses.dataclass(frozen=True)
class FusedReadout:
    mode: str                  # "current_sum" | "spike_count"


@dataclasses.dataclass(frozen=True)
class FusedStack:
    """The whole network, flattened into kernel-ready operands."""

    layers: Tuple[Any, ...]
    timesteps: int
    in_ic: int
    in_width: int
    n_classes: int
    # device -> packed operands; filled on first use, never compared
    _packed: Dict[str, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def conv_names(self) -> Tuple[str, ...]:
        return tuple(l.name for l in self.layers if isinstance(l, FusedConv))

    @property
    def n_convs(self) -> int:
        return max(1, len(self.conv_names))


def fused_conv_info(name: str, coo, lif, sched) -> FusedConv:
    """Build a conv layer's fused operands from its COO kernel + schedule."""
    w = np.asarray(coo_to_dense(coo), dtype=np.float32)   # (KW, IC, OC)
    w_cm = np.transpose(w, (2, 0, 1)).reshape(coo.oc, coo.kw * coo.ic)
    ic_idx = np.asarray(coo.row_idx) % coo.ic
    rows = np.asarray(coo.col_idx) * coo.ic + ic_idx      # ci-major row ids
    counts = np.bincount(rows, minlength=coo.kw * coo.ic) if coo.nnz else \
        np.zeros(coo.kw * coo.ic, dtype=np.int64)
    return FusedConv(
        name=name, kw=coo.kw, ic=coo.ic, oc=coo.oc,
        w_cm=np.ascontiguousarray(w_cm),
        counts=counts.astype(np.float32)[None, :],
        lif=_lif_rows(lif, coo.oc),
        static_counts={
            "reps_per_timestep": sched.reps,
            "compute_iters": sched.n_compute,
            "extra_iters": sched.n_extra,
            "empty_iters": sched.n_empty,
        })


def fused_fc_info(name: str, w: np.ndarray, lif) -> FusedFC:
    w = np.ascontiguousarray(np.asarray(w, dtype=np.float32))
    return FusedFC(name=name, w=w, lif=_lif_rows(lif, w.shape[1]))


def fused_stack_of(plan) -> Optional[FusedStack]:
    """Assemble a FusedStack from an ExecutionPlan, or None unless every
    weighted layer is assigned ``cuda_fused`` and carries fused operands."""
    layers = []
    for lp in plan.layers:
        kind = lp.spec.kind
        if kind in (_KIND_CONV, _KIND_FC):
            if lp.backend != FUSED_BACKEND or lp.cell.fused is None:
                return None
            layers.append(lp.cell.fused)
        elif kind == _KIND_POOL:
            layers.append(FusedPool(lp.spec.pool))
        elif kind == _KIND_READOUT:
            layers.append(FusedReadout(lp.spec.mode))
        else:
            return None
    cfg = plan.cfg
    return FusedStack(layers=tuple(layers), timesteps=cfg.timesteps,
                      in_ic=cfg.conv_specs[0][1], in_width=cfg.input_width,
                      n_classes=cfg.fc_specs[-1][1])


def fused_counters(stack: FusedStack, accs_row) -> Dict[str, Dict]:
    """Per-conv-layer Tables I/III counters for one sample's ``accs`` row."""
    out: Dict[str, Dict] = {}
    i = 0
    for layer in stack.layers:
        if isinstance(layer, FusedConv):
            out[layer.name] = {**layer.static_counts,
                               "accumulations": accs_row[i],
                               "timesteps": stack.timesteps}
            i += 1
    return out


def _check_frames(stack: FusedStack, frames: torch.Tensor, encode: bool):
    if frames.dtype != torch.float32:
        raise TypeError(f"frames must be float32, got {frames.dtype}")
    if encode:
        if frames.dim() != 3:
            raise ValueError(f"encode=True takes (B, IC, W), got {tuple(frames.shape)}")
        _, ic0, w0 = frames.shape
    else:
        if frames.dim() != 4:
            raise ValueError(f"frames must be (B, T, IC, W), got {tuple(frames.shape)}")
        _, t_f, ic0, w0 = frames.shape
        if t_f != stack.timesteps:
            raise ValueError(f"frames have T={t_f}, stack expects {stack.timesteps}")
    if (ic0, w0) != (stack.in_ic, stack.in_width):
        raise ValueError(f"frames are ({ic0}, {w0}), stack expects "
                         f"({stack.in_ic}, {stack.in_width})")


# ---------------------------------------------------------------------------
# The plain PyTorch version.
# ---------------------------------------------------------------------------

def _plain_operands(stack: FusedStack, device: torch.device):
    key = f"plain:{device}"
    ops = stack._packed.get(key)
    if ops is None:
        ops = []
        for layer in stack.layers:
            if isinstance(layer, FusedConv):
                ops.append((torch.as_tensor(layer.w_cm, device=device),
                            torch.as_tensor(layer.counts[0].astype(np.int64),
                                            device=device),
                            torch.as_tensor(layer.lif, device=device)))
            elif isinstance(layer, FusedFC):
                ops.append((torch.as_tensor(layer.w, device=device),
                            torch.as_tensor(layer.lif, device=device),
                            torch.as_tensor((layer.w != 0).sum(1),
                                            dtype=torch.float64,
                                            device=device)))
            else:
                ops.append(None)
        stack._packed[key] = ops
    return ops


def _lif_plain(v, cur, alpha, theta, vth):
    v_acc = alpha * v + cur
    s = (v_acc > vth).to(v.dtype)
    return v_acc - theta * s, s


def stream_fused_forward_ref(stack: FusedStack, frames: torch.Tensor, *,
                             encode: bool = False,
                             work: Optional[Dict[str, int]] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernel, on ``frames``' device.

    ``work``, when given, receives the gated adds these inputs need
    (``conv_adds``, ``fc_adds``) and the LIF neuron updates
    (``lif_updates``): the operation count of the kernel's bound.
    """
    _check_frames(stack, frames, encode)
    dev = frames.device
    ops = _plain_operands(stack, dev)
    b = frames.shape[0]
    f32 = torch.float32
    logits = torch.zeros((b, stack.n_classes), dtype=f32, device=dev)
    accs = torch.zeros((b, stack.n_convs), dtype=torch.long, device=dev)
    conv_adds = fc_adds = lif_updates = 0
    # membranes, walking the static width through the graph
    states = []
    width = stack.in_width
    for layer in stack.layers:
        if isinstance(layer, FusedConv):
            states.append(torch.zeros((b, layer.oc, width), dtype=f32, device=dev))
        elif isinstance(layer, FusedFC):
            states.append(torch.zeros((b, layer.w.shape[1]), dtype=f32, device=dev))
        else:
            states.append(None)
            if isinstance(layer, FusedPool):
                width //= layer.pool
    if encode:
        integ = torch.zeros_like(frames)
        y_prev = torch.zeros_like(frames)

    for t in range(stack.timesteps):
        if encode:
            integ = integ + frames - y_prev
            y_prev = (integ >= 0.5).to(f32)
            x = y_prev
        else:
            x = frames[:, t]
        last_cur = None
        conv_i = 0
        for li, layer in enumerate(stack.layers):
            if isinstance(layer, FusedConv):
                w_cm, counts, lif = ops[li]
                w = x.shape[-1]
                left = (layer.kw - 1) // 2
                xp = torch.nn.functional.pad(x, (left, layer.kw - 1 - left))
                # X' row sums, ci-major r = ci*IC + ic
                rows = torch.stack([xp[:, :, ci:ci + w].sum(-1)
                                    for ci in range(layer.kw)], 1)
                rows = rows.reshape(b, -1).to(torch.long)
                accs[:, conv_i] += (rows * counts).sum(-1)
                cur = torch.zeros((b, layer.oc, w), dtype=f32, device=dev)
                for ci in range(layer.kw):
                    for ic in range(layer.ic):
                        r = ci * layer.ic + ic
                        cur = cur + (w_cm[:, r, None]
                                     * xp[:, ic, None, ci:ci + w])
                v, x = _lif_plain(states[li], cur, lif[0][:, None],
                                  lif[1][:, None], lif[2][:, None])
                states[li] = v
                if work is not None:
                    conv_adds += int((rows * counts).sum())
                    lif_updates += v.numel()
                conv_i += 1
            elif isinstance(layer, FusedPool):
                c, w = x.shape[-2:]
                w2 = (w // layer.pool) * layer.pool
                x = x[..., :w2].reshape(b, c, w2 // layer.pool,
                                        layer.pool).amax(-1)
            elif isinstance(layer, FusedFC):
                w_fc, lif, nnz_rows = ops[li]
                xf = x.reshape(b, -1)
                cur = torch.zeros((b, w_fc.shape[1]), dtype=f32, device=dev)
                for i in range(w_fc.shape[0]):
                    cur = cur + xf[:, i, None] * w_fc[i]
                v, x = _lif_plain(states[li], cur, lif[0], lif[1], lif[2])
                states[li] = v
                last_cur = cur
                if work is not None:
                    fc_adds += int((xf != 0).to(torch.float64).sum(0) @ nnz_rows)
                    lif_updates += v.numel()
            else:  # FusedReadout
                contrib = last_cur if layer.mode == "current_sum" else x
                logits = logits + contrib
    if work is not None:
        work.update(conv_adds=conv_adds, fc_adds=fc_adds,
                    lif_updates=lif_updates)
    return logits, accs.to(f32)


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------

# meta layout: kept in sync with csrc/stream_fused.cu
_HDR, _OPW = 32, 16
_H = {name: i for i, name in enumerate(
    ("NOPS", "T", "IC", "W", "NCLS", "NCONV", "ACTA", "ACTB", "CUR", "LOGIT",
     "INTEG", "YPREV", "XIN", "IDX", "CHUNK", "ACCS"))}
_OP_CONV, _OP_POOL, _OP_FC, _OP_READOUT = 0, 1, 2, 3


def _pack(stack: FusedStack, device: torch.device):
    """(meta, params, counts) device tensors and the two layouts' sizes."""
    key = f"kernel:{device}"
    packed = stack._packed.get(key)
    if packed is not None:
        return packed
    n_ops = len(stack.layers)
    meta = np.zeros(_HDR + _OPW * n_ops, dtype=np.int32)
    params, counts = [], []
    p_off = c_off = 0
    smem = 0          # shared memory cursor, in 4-byte words

    def put_params(a):
        nonlocal p_off
        a = np.ascontiguousarray(a, dtype=np.float32).reshape(-1)
        params.append(a)
        off, p_off = p_off, p_off + a.size
        return off

    def take(n):
        nonlocal smem
        off, smem = smem, smem + n
        return off

    c, w = stack.in_ic, stack.in_width
    act = c * w
    max_din = max_dout = 1
    conv_i = 0
    for i, layer in enumerate(stack.layers):
        op = meta[_HDR + _OPW * i:_HDR + _OPW * (i + 1)]
        if isinstance(layer, FusedConv):
            if layer.ic != c:
                raise ValueError(f"{layer.name}: input has {c} channels, "
                                 f"layer expects {layer.ic}")
            k = layer.kw * layer.ic
            op[:11] = (_OP_CONV, layer.kw, layer.ic, layer.oc, w,
                       put_params(layer.w_cm), put_params(layer.lif), c_off,
                       take(layer.oc * k), take(layer.oc * w), conv_i)
            counts.append(layer.counts[0].astype(np.int32))
            c_off += k
            c = layer.oc
            conv_i += 1
        elif isinstance(layer, FusedPool):
            op[:2] = (_OP_POOL, layer.pool)
            w //= layer.pool
        elif isinstance(layer, FusedFC):
            din, dout = layer.w.shape
            if din != c * w:
                raise ValueError(f"{layer.name}: input has {c * w} values, "
                                 f"layer expects {din}")
            op[:3] = (_OP_FC, din, dout)
            op[5:7] = (put_params(layer.w), put_params(layer.lif))
            op[9] = take(dout)
            max_din, max_dout = max(max_din, din), max(max_dout, dout)
            c, w = dout, 1
        else:
            op[:3] = (_OP_READOUT, 0 if layer.mode == "current_sum" else 1,
                      stack.n_classes)
        act = max(act, c * w)
    n_in = stack.in_ic * stack.in_width
    hdr = {
        "NOPS": n_ops, "T": stack.timesteps, "IC": stack.in_ic,
        "W": stack.in_width, "NCLS": stack.n_classes, "NCONV": stack.n_convs,
        "ACTA": take(act), "ACTB": take(act),
        "CUR": take(max_dout), "LOGIT": take(stack.n_classes),
        "INTEG": take(n_in), "YPREV": take(n_in), "XIN": take(n_in),
        "IDX": take(max_din), "CHUNK": take((max_din + 31) // 32 + 1),
        "ACCS": take(stack.n_convs),
    }
    for name, val in hdr.items():
        meta[_H[name]] = val
    smem_bytes = 4 * smem
    if smem_bytes > MAX_SMEM:
        raise ValueError(f"fused stack needs {smem_bytes} bytes of shared "
                         f"memory; a block has at most {MAX_SMEM}")
    counts_np = (np.concatenate(counts) if counts
                 else np.zeros(1, dtype=np.int32))
    packed = (torch.as_tensor(meta, device=device),
              torch.as_tensor(np.concatenate(params), device=device),
              torch.as_tensor(counts_np, device=device),
              smem_bytes)
    stack._packed[key] = packed
    return packed


def _launch(stack: FusedStack, frames: torch.Tensor, encode: bool):
    from repro_torch.kernels.build import check, kernel_function

    meta, params, counts, smem_bytes = _pack(stack, frames.device)
    frames = frames.contiguous()
    b = frames.shape[0]
    logits = torch.empty((b, stack.n_classes), dtype=torch.float32,
                         device=frames.device)
    accs = torch.empty((b, stack.n_convs), dtype=torch.float32,
                       device=frames.device)
    if b == 0:
        return logits, accs
    vp = ctypes.c_void_p
    fn = kernel_function("stream_fused_forward_f32",
                         [vp, vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, vp])
    err = fn(meta.data_ptr(), params.data_ptr(), counts.data_ptr(),
             frames.data_ptr(), logits.data_ptr(), accs.data_ptr(), b,
             int(encode), smem_bytes, torch.cuda.current_stream(frames.device).cuda_stream)
    check(err, "stream_fused_forward_f32")
    stream_fused_forward.launches += 1
    return logits, accs


def stream_fused_forward(stack: FusedStack, frames: torch.Tensor, *,
                         encode: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the whole network: ``(logits (B, n_classes), conv_accs (B, n_convs))``.

    frames: (B, T, IC0, W) binary spike frames — or, with ``encode=True``,
    (B, IC0, W) normalized analog values in [0, 1] that the fused Σ-Δ
    modulator turns into spikes.  A CUDA tensor runs the kernel; a CPU
    tensor runs :func:`stream_fused_forward_ref`.
    """
    _check_frames(stack, frames, encode)
    if frames.device.type == "cuda":
        return _launch(stack, frames, encode)
    if frames.device.type != "cpu":
        raise ValueError(f"unsupported device {frames.device}")
    return stream_fused_forward_ref(stack, frames, encode=encode)


stream_fused_forward.launches = 0
