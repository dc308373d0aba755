"""Whole-network streaming SNN forward in one CUDA launch.

Replaces the Pallas kernel ``repro/kernels/stream_fused.py::
stream_fused_forward``.  The kernel (``csrc/stream_fused.cu``) gives each
sample a thread-block cluster of C CTAs, split by output channel (the
paper's output-channel dataflow): CTA q owns ceil(OC / C) channels of every
conv and ceil(OUT / C) outputs of every FC, keeps their weights and
membranes in its shared memory for all T timesteps, and after each layer
reads the other CTAs' spikes through distributed shared memory.  A conv
warp walks one channel's nonzero weights in ascending shift-buffer row
over 32 x P output positions, so each lane keeps P independent chains;
an FC thread walks the active inputs over its output's weights, held in
shared memory where they fit.  What bounds it on the H100 is the f32 adds
on the CUDA cores and the shared-memory loads that feed them, a few
microseconds of work for a batch of 64 (see PERF.md).

:func:`plan_stream_fused_launch` picks C, the shared-memory layout and
which FC weight slices stay resident, in plain Python; the packing helpers
(:func:`conv_weight_lists`, :func:`counter_map`) build the kernel's
operands from the same numpy arrays as the reference.

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
import functools
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
    "FusedLaunch",
    "plan_stream_fused_launch",
    "launch_plan",
    "max_active_clusters",
    "conv_weight_lists",
    "counter_map",
    "split_outputs",
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


def _row_sums(xp: torch.Tensor, kw: int, w: int) -> torch.Tensor:
    """(B, KW, IC) sums of the X' rows ``xp[:, ic, ci:ci + w]``.  A {0, 1}
    input sums exactly in any order; any other input is summed in
    ascending position, the order the kernel uses."""
    if bool(((xp == 0) | (xp == 1)).all()):
        return torch.stack([xp[:, :, ci:ci + w].sum(-1) for ci in range(kw)], 1)
    acc = torch.zeros(xp.shape[:2] + (kw,), dtype=xp.dtype, device=xp.device)
    for p in range(w):
        acc = acc + xp[:, :, p:p + kw]
    return acc.transpose(1, 2)


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
                rows = _row_sums(xp, layer.kw, w).reshape(b, -1).to(torch.long)
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
# Launch planning and operand packing for the CUDA kernel.
# ---------------------------------------------------------------------------

CLUSTERS = (1, 2, 4, 8)   # CTAs per sample: the portable thread-block cluster sizes
THREAD_COUNTS = (512, 256)  # threads per CTA the planner may choose
SM_SMEM = 233_472         # shared memory of one SM; the card keeps 1 KB per block
SM_REGS = 65_536
MAX_REGS = 128            # per thread: __launch_bounds__(512, 1) in csrc/stream_fused.cu
N_SMS = 132               # SMs of an H100 SXM (the wrapper asks the card)
POSITIONS = (4, 2, 1)     # conv output positions per lane (template P of the kernel)
LIST_GROUP = 4            # a channel's weight list is padded to a multiple of this
STAGE_ROWS = 256          # active non-resident FC weight rows staged a timestep


@dataclasses.dataclass(frozen=True)
class _Stage:
    """A weighted layer of the kernel: a conv with the pool after it
    (``pool`` 1 when none follows), or an FC."""
    layer: Any
    width: int      # conv input width (1 for an FC)
    pool: int


def _stages(stack: FusedStack) -> Tuple[Tuple[_Stage, ...], str]:
    """The kernel's stages and readout mode; raises on a layer order the
    kernel does not run: (conv [pool])* fc+ readout."""
    stages = []
    readout = None
    c, w = stack.in_ic, stack.in_width
    layers = stack.layers
    i = 0
    while i < len(layers):
        layer = layers[i]
        if readout is not None:
            raise ValueError("the readout must be the last layer")
        if isinstance(layer, FusedConv):
            if stages and isinstance(stages[-1].layer, FusedFC):
                raise ValueError(f"{layer.name}: a conv after an FC layer")
            if layer.ic != c:
                raise ValueError(f"{layer.name}: input has {c} channels, "
                                 f"layer expects {layer.ic}")
            pool = 1
            if i + 1 < len(layers) and isinstance(layers[i + 1], FusedPool):
                pool = layers[i + 1].pool
                i += 1
            if pool < 1 or w // pool < 1:
                raise ValueError(f"pool {pool} after {layer.name} (width {w})")
            stages.append(_Stage(layer, w, pool))
            c, w = layer.oc, w // pool
        elif isinstance(layer, FusedFC):
            din, dout = layer.w.shape
            if din != c * w:
                raise ValueError(f"{layer.name}: input has {c * w} values, "
                                 f"layer expects {din}")
            stages.append(_Stage(layer, 1, 1))
            c, w = dout, 1
        elif isinstance(layer, FusedReadout):
            if not stages or not isinstance(stages[-1].layer, FusedFC):
                raise ValueError("the readout must follow an FC layer")
            readout = layer.mode
        else:
            raise ValueError(f"a {type(layer).__name__} must follow a conv layer")
        i += 1
    if readout is None:
        raise ValueError("the stack has no readout")
    if stages[-1].layer.w.shape[1] != stack.n_classes:
        raise ValueError(f"the last FC has {stages[-1].layer.w.shape[1]} outputs, "
                         f"the stack {stack.n_classes} classes")
    return tuple(stages), readout


def _outputs(stage: _Stage) -> int:
    layer = stage.layer
    return layer.oc if isinstance(layer, FusedConv) else layer.w.shape[1]


def split_outputs(n: int, cluster: int) -> Tuple[Tuple[int, int], ...]:
    """CTA q of a cluster owns outputs [start, stop): ceil(n / C) each,
    the last CTAs fewer or none."""
    per = -(-n // cluster)
    return tuple((min(n, q * per), min(n, (q + 1) * per)) for q in range(cluster))


def conv_weight_lists(layer: FusedConv, width: int, cluster: int):
    """Each CTA's nonzero conv weights, channel by channel, in ascending
    shift-buffer row ``r = ci*IC + ic`` (the GOAP schedule of the fixed
    kernel).  Returns ``(entries (C, L, 2) float32, rowptr (C, per+1)
    int32)``: entry = (weight, offset) with the int32 offset ``ic * (width
    + kw - 1) + ci`` stored in the float's bits, the offset into the
    zero-padded input rows at which output position 0 reads; each
    channel's list padded with (0, 0) to a multiple of 4 entries, and 8
    more (0, 0) entries after the CTA's last channel, which the kernel's
    walk reads ahead of use."""
    wp = width + layer.kw - 1
    rows = np.arange(layer.kw * layer.ic)
    offsets = ((rows % layer.ic) * wp + rows // layer.ic).astype(np.int32)
    per = -(-layer.oc // cluster)
    lists, ptrs = [], []
    for start, stop in split_outputs(layer.oc, cluster):
        ws, offs, ptr = [], [], [0]
        for ch in range(start, stop):
            nz = np.flatnonzero(layer.w_cm[ch])
            pad = -len(nz) % LIST_GROUP
            ws += [layer.w_cm[ch, nz], np.zeros(pad, np.float32)]
            offs += [offsets[nz], np.zeros(pad, np.int32)]
            ptr.append(ptr[-1] + len(nz) + pad)
        ptrs.append(ptr + [ptr[-1]] * (per + 1 - len(ptr)))
        lists.append((np.concatenate(ws) if ws else np.zeros(0, np.float32),
                      np.concatenate(offs) if offs else np.zeros(0, np.int32)))
    n = max(len(w) for w, _ in lists) + 2 * LIST_GROUP
    entries = np.zeros((cluster, n, 2), np.float32)
    for q, (w, off) in enumerate(lists):
        entries[q, :len(w), 0] = w
        entries[q, :len(w), 1] = off.view(np.float32)
    return entries, np.asarray(ptrs, np.int32)


def counter_map(layer: FusedConv, width: int) -> np.ndarray:
    """(IC, W) int32 ``c`` with ``sum(x * c) == sum_r counts[r] *
    rowsum(X'[r])`` for a {0, 1} input ``x``: input position p lies in
    shift-buffer row (ci, ic)'s window when ``ci - left <= p < ci - left +
    W``."""
    left = (layer.kw - 1) // 2
    counts = layer.counts[0].astype(np.int64).reshape(layer.kw, layer.ic)
    cmap = np.zeros((layer.ic, width), np.int64)
    for ci in range(layer.kw):
        lo, hi = max(0, ci - left), min(width, ci - left + width)
        cmap[:, lo:hi] += counts[ci][:, None]
    return cmap.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class FusedLaunch:
    """One launch of ``csrc/stream_fused.cu``: a cluster of ``cluster``
    CTAs per sample, each of ``threads`` threads and ``smem_bytes`` of
    dynamic shared memory laid out as ``layout`` ((region, word offset,
    words), ...); ``fc_rows`` says, per FC layer, how many input rows of
    its weight slice a CTA holds in shared memory (it reads the rest from
    global memory), ``fc_staged`` how many of each timestep's active rows
    past them it copies into a staging area first, and ``fc_resident``
    whether the resident rows are all of them; ``positions`` is, per conv, the output positions a lane
    owns; ``owned`` is, per conv and FC layer, each CTA's [start, stop) of
    output channels or outputs.  ``waves`` is the batch's CTAs over what
    the card holds at once, ``ctas_per_sm`` per SM."""
    cluster: int
    threads: int
    smem_bytes: int
    fc_resident: Tuple[bool, ...]
    fc_rows: Tuple[int, ...]
    fc_staged: Tuple[int, ...]
    positions: Tuple[int, ...]
    owned: Tuple[Tuple[Tuple[int, int], ...], ...]
    layout: Tuple[Tuple[str, int, int], ...]
    ctas_per_sm: int
    waves: int

    def region(self, name: str) -> int:
        return next(off for n, off, _ in self.layout if n == name)


def _positions(width: int, per: int, n_warps: int) -> int:
    """Output positions per lane for a conv: the most (4, 2, 1) that a
    32-lane warp's positions fit in the width and still give every warp a
    (channel, position group) task; else 1."""
    for p in POSITIONS:
        if 32 * p <= max(32, width) and per * -(-width // (32 * p)) >= n_warps:
            return p
    return 1


def _pool_by_shuffle(pool: int) -> bool:
    """A power-of-two pool of at most 32 runs on neighbouring lanes."""
    return pool <= 32 and pool & (pool - 1) == 0


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _in_words(stages, si) -> int:
    """Words of one copy of layer si's input buffer (16-byte multiple)."""
    layer = stages[si].layer
    if isinstance(layer, FusedConv):
        # + slack: lanes past the width read up to 127 words beyond
        return _round4(layer.ic * (stages[si].width + layer.kw - 1) + 128)
    return _round4(layer.w.shape[0])


def _in_bytes(stages, si) -> int:
    """Bytes every CTA receives into layer si's input each timestep."""
    prev = stages[si - 1]
    if isinstance(prev.layer, FusedConv):
        return 4 * prev.layer.oc * (prev.width // prev.pool)
    return 4 * prev.layer.w.shape[1]


def _layout(stack, stages, cluster, rows, list_len, staged=None):
    """((region, word offset, words), ...) and bytes of one CTA's shared
    memory: per layer its input buffer and owned operands, FC weight
    slices' first ``rows`` input rows (the others are read from L2)."""
    regions = []
    cursor = 0

    def take(name, words):
        nonlocal cursor
        regions.append((name, cursor, int(words)))
        cursor += _round4(int(words))          # 16-byte aligned regions

    spk = max_din = stage = 1
    fc_i = 0
    take("meta", _HDR + _OPW * len(stages))     # copied in by the kernel
    for si, st in enumerate(stages):
        per = -(-_outputs(st) // cluster)
        if isinstance(st.layer, FusedConv):
            k = st.layer
            # + slack: lanes past the width read up to 127 words beyond;
            # a layer fed by another has one buffer per timestep parity
            take(f"in{si}", _in_words(stages, si) * (2 if si else 1))
            take(f"list{si}", 2 * list_len[si])
            take(f"rowptr{si}", per + 1)
            take(f"cmap{si}", -(-k.ic * st.width // cluster))
            take(f"v{si}", per * st.width)
            take(f"lif{si}", 3 * per)
            if not _pool_by_shuffle(st.pool):
                spk = max(spk, per * st.width)
        else:
            din = st.layer.w.shape[0]
            take(f"in{si}", _in_words(stages, si) * (2 if si else 1))
            if rows[fc_i]:
                take(f"w{si}", rows[fc_i] * _round4(per))
            if staged:
                stage = max(stage, staged[fc_i] * _round4(per))
            take(f"v{si}", per)
            take(f"lif{si}", 3 * per)
            max_din = max(max_din, din)
            fc_i += 1
    n_in = stack.in_ic * stack.in_width
    take("mbar", 4 * len(stages))      # two 8-byte mbarriers a layer
    for name, words in (("spk", spk), ("stage", stage), ("idx", max_din + 40),
                        ("mask", -(-max_din // 32) + 1),
                        ("logit", -(-stack.n_classes // cluster)),
                        ("accs", 3 * stack.n_convs),
                        ("frm", stack.timesteps * n_in), ("integ", n_in),
                        ("yprev", n_in)):
        take(name, words)
    return tuple(regions), 4 * cursor


def plan_stream_fused_launch(stack: FusedStack, batch: int, *,
                             n_sms: int = N_SMS,
                             cluster: Optional[int] = None,
                             threads: Optional[int] = None,
                             fc_resident: Optional[Tuple[bool, ...]] = None,
                             active_clusters=None) -> FusedLaunch:
    """The cluster size, threads, shared-memory layout and FC residency of
    a launch.

    For each cluster size C in (1, 2, 4, 8) and each thread count (or the
    ones given), every CTA owns ceil(OC / C) channels of each conv and
    ceil(OUT / C) outputs of each FC; FC weight slices are held in shared
    memory where they fit; for the largest FC layers that do not fit, a
    staging area of up to 256 rows, into which each timestep's active rows
    past the resident ones are copied, and as many resident input rows (a
    multiple of 32) as fit beside it; rows past both are read from global
    memory (L2) (or all rows resident or none, as ``fc_resident`` says).
    ``active_clusters(C, threads, smem_bytes)`` is how many such clusters
    the card holds at once (the wrapper asks the card; by default an
    estimate from ``n_sms``), which gives the waves the batch takes.  Among
    the plans whose CTA fits in 227 KB it takes the fewest waves, then the
    most FC weights resident, then the largest C (more SMs per sample),
    then the most threads.  Raises past 232,448 bytes."""
    stages, _ = _stages(stack)
    fcs = [i for i, st in enumerate(stages) if isinstance(st.layer, FusedFC)]
    if fc_resident is not None and len(fc_resident) != len(fcs):
        raise ValueError(f"fc_resident has {len(fc_resident)} entries for "
                         f"{len(fcs)} FC layers")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"cluster {cluster} is not one of {CLUSTERS}")
    if threads is not None and threads not in THREAD_COUNTS:
        raise ValueError(f"threads {threads} is not one of {THREAD_COUNTS}")
    options, smallest = [], None
    for c in (CLUSTERS if cluster is None else (cluster,)):
        list_len = {i: conv_weight_lists(st.layer, st.width, c)[0].shape[1]
                    for i, st in enumerate(stages)
                    if isinstance(st.layer, FusedConv)}
        dins = [stages[i].layer.w.shape[0] for i in fcs]
        staged = [0] * len(fcs)
        if fc_resident is not None:
            rows = [d if r else 0 for d, r in zip(dins, fc_resident)]
            layout, smem = _layout(stack, stages, c, rows, list_len)
        else:   # all rows; else, for the largest FC first, a staging area
            rows = list(dins)   # and as many resident rows as fit beside it
            layout, smem = _layout(stack, stages, c, rows, list_len)
            for j in sorted(range(len(fcs)),
                            key=lambda j: -stages[fcs[j]].layer.w.size):
                if smem <= MAX_SMEM:
                    break
                rows[j] = 0
                _, smem0 = _layout(stack, stages, c, rows, list_len, staged)
                row_bytes = 4 * _round4(-(-_outputs(stages[fcs[j]]) // c))
                fit = max(0, (MAX_SMEM - smem0 - 16) // row_bytes)
                staged[j] = min(dins[j], STAGE_ROWS, fit // 8 * 8)
                rows[j] = min(dins[j], (fit - staged[j]) // 32 * 32)
                layout, smem = _layout(stack, stages, c, rows, list_len, staged)
        smallest = smem if smallest is None else min(smallest, smem)
        if smem > MAX_SMEM:
            continue
        resident = tuple(r == d for r, d in zip(rows, dins))
        owned = tuple(split_outputs(_outputs(st), c) for st in stages)
        off_chip = sum((d - r) * _outputs(stages[fcs[j]])
                       for j, (r, d) in enumerate(zip(rows, dins)))
        for n_threads in (THREAD_COUNTS if threads is None else (threads,)):
            per_sm = min(SM_SMEM // (smem + 1024),
                         SM_REGS // (MAX_REGS * n_threads))
            if active_clusters is None:
                active = per_sm * n_sms // c
            else:
                active = active_clusters(c, n_threads, smem)
            waves = -(-max(1, batch) // max(1, active))
            positions = tuple(
                _positions(st.width, -(-st.layer.oc // c), n_threads // 32)
                for st in stages if isinstance(st.layer, FusedConv))
            options.append(((waves, off_chip, -c, -n_threads), FusedLaunch(
                c, n_threads, smem, resident, tuple(rows), tuple(staged),
                positions, owned, layout, per_sm, waves)))
    if not options:
        raise ValueError(f"a CTA needs at least {smallest} bytes of shared "
                         f"memory; the H100 gives {MAX_SMEM}")
    return min(options, key=lambda o: o[0])[1]


# meta layout: kept in sync with csrc/stream_fused.cu
_HDR, _OPW = 32, 40
_H = {name: i for i, name in enumerate(
    ("NOPS", "T", "IC", "W", "NCLS", "NCONV", "C", "NIN", "READOUT", "SPK",
     "IDX", "MASK", "LOGIT", "ACCS", "FRM", "INTEG", "YPREV"))}
_CONV = {name: i for i, name in enumerate(
    ("KIND", "KW", "IC", "OC", "W", "POOL", "PER", "P", "SIN", "SNEXT", "NKW",
     "SHFL", "SLIST", "GLIST", "NLIST", "SRP", "GRP", "NRP", "SCMAP", "GCMAP",
     "NCMAP", "SLIF", "GLIF", "NLIF", "SV", "GCNT", "GW", "CIDX", "MB", "EXPB",
     "INSZ", "NMB", "NSZ"))}
_FC = {name: i for i, name in enumerate(
    ("KIND", "DIN", "DOUT", "PER", "DPAD", "SIN", "SNEXT", "RROWS", "SW", "GW",
     "SLIF", "GLIF", "NLIF", "SV", "LAST", "MB", "EXPB", "INSZ", "NMB", "NSZ",
     "SROWS", "SSTG"))}
_OP_CONV, _OP_FC = 0, 1


def _per_cta(rows) -> np.ndarray:
    """Stack per-CTA 1-D slices into (C, n) with n a multiple of 4 (each
    CTA copies its row with 16-byte cp.async)."""
    n = _round4(max(len(r) for r in rows))
    out = np.zeros((len(rows), n), dtype=np.asarray(rows[0]).dtype)
    for q, r in enumerate(rows):
        out[q, :len(r)] = r
    return out


def _lif_slices(lif: np.ndarray, owned) -> np.ndarray:
    """Per CTA: [alpha, theta, v_th] of its owned outputs, ceil(n / C) each."""
    per = -(-lif.shape[1] // len(owned))
    rows = []
    for start, stop in owned:
        part = np.zeros((3, per), np.float32)
        part[:, :stop - start] = lif[:, start:stop]
        rows.append(part.reshape(-1))
    return _per_cta(rows)


def _exchange(plan: FusedLaunch, stages, si) -> Dict[str, int]:
    """Meta fields of layer si's input exchange: its mbarriers, the bytes
    it receives a timestep, its buffer copy size, and the next layer's."""
    mbar = plan.region("mbar")
    nxt = si + 1 < len(stages)
    return dict(MB=mbar + 4 * si, EXPB=_in_bytes(stages, si) if si else 0,
                INSZ=_in_words(stages, si) if si else 0,
                NMB=mbar + 4 * (si + 1) if nxt else 0,
                NSZ=_in_words(stages, si + 1) if nxt else 0)


def _pack(stack: FusedStack, plan: FusedLaunch, device: torch.device):
    """(meta, f32 operands, int32 operands) on ``device`` for ``plan``."""
    key = ("kernel", str(device), plan)
    packed = stack._packed.get(key)
    if packed is not None:
        return packed
    stages, readout = _stages(stack)
    c = plan.cluster
    meta = np.zeros(_HDR + _OPW * len(stages), dtype=np.int32)
    parts = ([], [])       # f32 operands, int32 operands
    sizes = [0, 0]

    def put(which, a):
        a = np.ascontiguousarray(a).reshape(-1)
        off = sizes[which]
        parts[which].append(np.concatenate([a, np.zeros(-a.size % 4, a.dtype)]))
        sizes[which] += _round4(a.size)
        return off

    def region(name):
        return plan.region(name)

    fc_i = conv_i = 0
    for si, st in enumerate(stages):
        op = meta[_HDR + _OPW * si:_HDR + _OPW * (si + 1)]
        layer = st.layer
        per = -(-_outputs(st) // c)
        nxt = stages[si + 1].layer if si + 1 < len(stages) else None
        snext = region(f"in{si + 1}") if nxt is not None else 0
        lif = _lif_slices(layer.lif.astype(np.float32), plan.owned[si])
        if isinstance(layer, FusedConv):
            if not np.isfinite(layer.w_cm).all():
                raise ValueError(f"{layer.name}: weights must be finite")
            entries, rowptr = conv_weight_lists(layer, st.width, c)
            share = -(-layer.ic * st.width // c)
            cmap = counter_map(layer, st.width).reshape(-1)
            cmap = _per_cta([cmap[q * share:(q + 1) * share] for q in range(c)])
            rowptr = _per_cta(list(rowptr))
            vals = dict(
                KIND=_OP_CONV, KW=layer.kw, IC=layer.ic, OC=layer.oc, W=st.width,
                POOL=st.pool, PER=per, P=plan.positions[conv_i],
                SIN=region(f"in{si}"), SNEXT=snext,
                NKW=nxt.kw if isinstance(nxt, FusedConv) else 0,
                SHFL=int(_pool_by_shuffle(st.pool)),
                SLIST=region(f"list{si}"), GLIST=put(0, entries),
                NLIST=2 * entries.shape[1],
                SRP=region(f"rowptr{si}"), GRP=put(1, rowptr), NRP=rowptr.shape[1],
                SCMAP=region(f"cmap{si}"), GCMAP=put(1, cmap), NCMAP=cmap.shape[1],
                SLIF=region(f"lif{si}"), GLIF=put(0, lif), NLIF=lif.shape[1],
                SV=region(f"v{si}"),
                GCNT=put(1, layer.counts[0].astype(np.int32)),
                GW=put(0, layer.w_cm.astype(np.float32)), CIDX=conv_i,
                **_exchange(plan, stages, si))
            for name, v in vals.items():
                op[_CONV[name]] = v
            conv_i += 1
        else:
            if not np.isfinite(layer.w).all():
                raise ValueError(f"{layer.name}: weights must be finite")
            din, dout = layer.w.shape
            dpad = _round4(per)
            sliced = np.zeros((c, din, dpad), np.float32)
            for q, (start, stop) in enumerate(plan.owned[si]):
                sliced[q, :, :stop - start] = layer.w[:, start:stop]
            n_rows = plan.fc_rows[fc_i]
            vals = dict(
                KIND=_OP_FC, DIN=din, DOUT=dout, PER=per, DPAD=dpad,
                SIN=region(f"in{si}"), SNEXT=snext, RROWS=n_rows,
                SW=region(f"w{si}") if n_rows else 0, GW=put(0, sliced),
                SLIF=region(f"lif{si}"), GLIF=put(0, lif), NLIF=lif.shape[1],
                SV=region(f"v{si}"), LAST=int(nxt is None),
                SROWS=plan.fc_staged[fc_i], SSTG=region("stage"),
                **_exchange(plan, stages, si))
            for name, v in vals.items():
                op[_FC[name]] = v
            fc_i += 1
    hdr = dict(NOPS=len(stages), T=stack.timesteps, IC=stack.in_ic,
               W=stack.in_width, NCLS=stack.n_classes, NCONV=stack.n_convs,
               C=c, NIN=stack.in_ic * stack.in_width,
               READOUT=0 if readout == "current_sum" else 1,
               SPK=region("spk"), IDX=region("idx"), MASK=region("mask"),
               LOGIT=region("logit"), ACCS=region("accs"), FRM=region("frm"),
               INTEG=region("integ"), YPREV=region("yprev"))
    for name, v in hdr.items():
        meta[_H[name]] = v
    packed = (torch.as_tensor(meta, device=device),
              torch.as_tensor(np.concatenate(parts[0]), device=device),
              torch.as_tensor(np.concatenate(parts[1]), device=device))
    stack._packed[key] = packed
    return packed


@functools.lru_cache(maxsize=None)
def _n_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_plan(stack: FusedStack, batch: int,
                device: Optional[torch.device] = None) -> FusedLaunch:
    """The planner's launch for ``batch`` samples on ``device``'s card
    (waves from the card's own cluster occupancy), or on an estimated
    132-SM card where no card is given; cached on the stack."""
    on_card = device is not None and device.type == "cuda"
    key = ("plan", batch, str(device) if on_card else None)
    plan = stack._packed.get(key)
    if plan is None:
        plan = stack._packed[key] = plan_stream_fused_launch(
            stack, batch, n_sms=_n_sms(device) if on_card else N_SMS,
            active_clusters=_active_clusters if on_card else None)
    return plan


@functools.lru_cache(maxsize=None)
def _active_clusters(cluster: int, threads: int, smem_bytes: int) -> int:
    from repro_torch.kernels.build import check, kernel_function

    fn = kernel_function("stream_fused_max_active_clusters",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    check(fn(cluster, threads, smem_bytes, ctypes.byref(out)),
          "stream_fused_max_active_clusters")
    return out.value


def max_active_clusters(plan: FusedLaunch) -> int:
    """Clusters of ``plan``'s shape the card can hold at once
    (``cudaOccupancyMaxActiveClusters``); 0 where it can hold none."""
    return _active_clusters(plan.cluster, plan.threads, plan.smem_bytes)


def _launch(stack: FusedStack, frames: torch.Tensor, encode: bool,
            plan: Optional[FusedLaunch]):
    from repro_torch.kernels.build import check, kernel_function

    frames = frames.contiguous()
    b = frames.shape[0]
    logits = torch.empty((b, stack.n_classes), dtype=torch.float32,
                         device=frames.device)
    accs = torch.empty((b, stack.n_convs), dtype=torch.float32,
                       device=frames.device)
    if b == 0:
        return logits, accs
    if plan is None:
        plan = launch_plan(stack, b, frames.device)
    meta, fparams, iparams = _pack(stack, plan, frames.device)
    vp = ctypes.c_void_p
    fn = kernel_function("stream_fused_forward_f32",
                         [vp, vp, vp, vp, vp, vp] + [ctypes.c_int] * 5 + [vp])
    err = fn(meta.data_ptr(), fparams.data_ptr(), iparams.data_ptr(),
             frames.data_ptr(), logits.data_ptr(), accs.data_ptr(), b,
             int(encode), plan.cluster, plan.threads, plan.smem_bytes,
             torch.cuda.current_stream(frames.device).cuda_stream)
    check(err, "stream_fused_forward_f32")
    stream_fused_forward.launches += 1
    return logits, accs


def stream_fused_forward(stack: FusedStack, frames: torch.Tensor, *,
                         encode: bool = False,
                         plan: Optional[FusedLaunch] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the whole network: ``(logits (B, n_classes), conv_accs (B, n_convs))``.

    frames: (B, T, IC0, W) spike frames — or, with ``encode=True``,
    (B, IC0, W) normalized analog values in [0, 1] that the fused Σ-Δ
    modulator turns into spikes.  A CUDA tensor runs the kernel with
    ``plan`` (default: :func:`launch_plan` for this batch); a CPU tensor
    runs :func:`stream_fused_forward_ref`.
    """
    _check_frames(stack, frames, encode)
    if frames.device.type == "cuda":
        return _launch(stack, frames, encode, plan)
    if frames.device.type != "cpu":
        raise ValueError(f"unsupported device {frames.device}")
    return stream_fused_forward_ref(stack, frames, encode=encode)


stream_fused_forward.launches = 0
