"""SAOCDS layer dataflow (paper §III-C.4, Algorithms 1-2).

Port of ``repro/core/saocds.py``.  Two execution paths, held equal in the
tests:

* ``make_schedule_step`` / ``schedule_interpreter`` — the **streaming
  emulator** of the static Algorithm-2 schedule (compute / extra / empty
  iterations): first-touch load and decay of an output channel's
  membrane row, enable-map gated accumulation, fire + soft reset + emit on
  the channel's last iteration, and the gated accumulation counter (the
  quantity of paper Tables I/III).
* ``saocds_conv_step`` / ``saocds_conv_layer`` — the **vectorized path**
  (decay all, GOAP accumulate, fire), equal because every output channel
  is decayed exactly once per timestep.

The reference scans the schedule one iteration at a time.  Every entry
touches one channel's membrane row only, and a channel's entries are
contiguous in the schedule, so running the schedule equals running each
channel's own subsequence of entries in order, all channels side by side.
:func:`channel_slots` regroups the schedule that way once, at bind time:
slot ``s`` of channel ``c`` is the channel's ``s``-th entry, padded to the
longest channel with slots that change nothing.  A timestep then loops
over slots only (the longest channel's length, 15 / 100 / 94 for the paper
model's convs at density 0.5, against 176 / 2816 / 5120 schedule entries),
each slot one set of tensor ops over all channels and the whole batch.
Per element the arithmetic and its order are the reference's:
``alpha * v`` on first touch, then ``v + w * gated``, then fire and soft
reset on emit.  Empty iterations touch no channel and are dropped.

FC layers use the weight-mask method (paper §III-B); pooling over binary
spikes is a max (logical OR) over the window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.goap import (conv1d_dense_oracle, goap_conv_packed, goap_pack,
                                   matmul_rounded)
from repro_torch.core.lif import LIFParams, lif_step
from repro_torch.core.sparse_format import (
    ITER_COMPUTE,
    CooKernel,
    Schedule,
    WeightMask,
)

__all__ = [
    "pad_same",
    "max_pool_spikes",
    "saocds_conv_step",
    "saocds_conv_layer",
    "sw_conv_layer",
    "wm_fc_step",
    "wm_fc_layer",
    "ChannelSlots",
    "channel_slots",
    "make_schedule_step",
    "schedule_interpreter",
]


def pad_same(ifm: torch.Tensor, kw: int) -> torch.Tensor:
    """Zero-pad (..., IC, W) so that a valid conv of width kw keeps W."""
    left = (kw - 1) // 2
    return F.pad(ifm, (left, kw - 1 - left))


def max_pool_spikes(spikes: torch.Tensor, pool: int = 2) -> torch.Tensor:
    """(..., C, W) -> (..., C, W//pool); max == logical OR for binary spikes."""
    *lead, c, w = spikes.shape
    w2 = (w // pool) * pool
    x = spikes[..., :w2].reshape(*lead, c, w2 // pool, pool)
    return x.amax(dim=-1)


# ---------------------------------------------------------------------------
# Vectorized path.
# ---------------------------------------------------------------------------

def saocds_conv_step(v: torch.Tensor, ifm: torch.Tensor, coo: CooKernel,
                     lif: LIFParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """One timestep on a pre-padded binary IFM (..., IC, WI); v: (..., OC, OI).
    Returns (v_next, spikes)."""
    return lif_step(v, goap_conv_packed(ifm, goap_pack(coo)), lif)


def saocds_conv_layer(spikes_t: torch.Tensor, coo: CooKernel, lif: LIFParams,
                      v0: Optional[torch.Tensor] = None):
    """(T, ..., IC, WI) pre-padded binary frames -> ((T, ..., OC, OI) spikes,
    v_final)."""
    pack = goap_pack(coo)
    oi = spikes_t.shape[-1] - coo.kw + 1
    v = (spikes_t.new_zeros(spikes_t.shape[1:-2] + (coo.oc, oi),
                            dtype=torch.float32) if v0 is None else v0)
    outs = []
    for x in spikes_t:
        v, s = lif_step(v, goap_conv_packed(x, pack), lif)
        outs.append(s)
    return torch.stack(outs), v


def sw_conv_layer(spikes_t: torch.Tensor, kernel: torch.Tensor, lif: LIFParams,
                  v0: Optional[torch.Tensor] = None):
    """Sliding-window (FINN-style dense) baseline conv layer, same dynamics."""
    kw, _, oc = kernel.shape
    oi = spikes_t.shape[-1] - kw + 1
    v = (spikes_t.new_zeros(spikes_t.shape[1:-2] + (oc, oi),
                            dtype=torch.float32) if v0 is None else v0)
    outs = []
    for x in spikes_t:
        v, s = lif_step(v, conv1d_dense_oracle(x, kernel), lif)
        outs.append(s)
    return torch.stack(outs), v


def wm_fc_step(v: torch.Tensor, spikes: torch.Tensor, weights: torch.Tensor,
               lif: LIFParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """One timestep of a weight-masked FC layer (zeros kept in ``weights``)."""
    return lif_step(v, matmul_rounded(spikes.to(weights.dtype), weights), lif)


def wm_fc_layer(spikes_t: torch.Tensor, wm, lif: LIFParams,
                v0: Optional[torch.Tensor] = None):
    """(T, ..., IN) -> ((T, ..., OUT) spikes, v_final) through FC + LIF."""
    weights = torch.as_tensor(wm.weights if isinstance(wm, WeightMask) else wm)
    v = (weights.new_zeros(spikes_t.shape[1:-1] + (weights.shape[1],))
         if v0 is None else v0)
    outs = []
    for s in spikes_t:
        v, out = wm_fc_step(v, s, weights, lif)
        outs.append(out)
    return torch.stack(outs), v


# ---------------------------------------------------------------------------
# Streaming emulator (Algorithm 2), vectorized over output channels.
# ---------------------------------------------------------------------------

def _first_touch_flags(sched: Schedule) -> np.ndarray:
    """True on the first schedule entry that touches each output channel
    (the iteration that loads + decays that channel's membrane row)."""
    seen = set()
    flags = np.zeros(sched.reps, dtype=bool)
    for i in range(sched.reps):
        oc = int(sched.oc[i])
        if oc >= 0 and oc not in seen:
            seen.add(oc)
            flags[i] = True
    return flags


@dataclasses.dataclass(frozen=True)
class ChannelSlots:
    """An Algorithm-2 schedule regrouped by output channel.

    Every array is (OC, S), S the longest channel's entry count; slot ``s``
    of channel ``c`` is the ``s``-th schedule entry touching ``c``.  Padding
    slots have ``valid`` False, weight 0, and change nothing.
    """

    weight: np.ndarray       # f32; 0 for extra and padding slots
    ic: np.ndarray           # int64 input channel (0 where n/a)
    ci: np.ndarray           # int64 kernel column (0 where n/a)
    is_compute: np.ndarray   # bool: a gated accumulation (counted)
    first_touch: np.ndarray  # bool: load + decay the membrane row
    emit: np.ndarray         # bool: fire + soft reset + emit the row
    valid: np.ndarray        # bool: a real entry (not padding)

    @property
    def n_slots(self) -> int:
        return int(self.weight.shape[1])


def channel_slots(sched: Schedule, oc: int) -> ChannelSlots:
    """Regroup ``sched`` per output channel (numpy, once per bind)."""
    touched = np.nonzero(sched.oc >= 0)[0]          # empty entries dropped
    ch = sched.oc[touched].astype(np.int64)
    if np.any(np.diff(ch) < 0):
        raise ValueError("schedule is not output-channel-major")
    counts = np.bincount(ch, minlength=oc)
    n_slots = max(1, int(counts.max()) if counts.size else 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(touched.size) - starts[ch]
    first = _first_touch_flags(sched)

    def grid(values, dtype):
        out = np.zeros((oc, n_slots), dtype=dtype)
        out[ch, slot] = values
        return out

    is_compute = sched.kind[touched] == ITER_COMPUTE
    return ChannelSlots(
        weight=grid(np.where(is_compute, sched.weight[touched], 0.0), np.float32),
        ic=grid(np.maximum(sched.ic[touched], 0), np.int64),
        ci=grid(sched.ci[touched], np.int64),
        is_compute=grid(is_compute, bool),
        first_touch=grid(first[touched], bool),
        emit=grid(sched.emit[touched], bool),
        valid=grid(True, bool))


class _StagedSlots:
    """ChannelSlots as tensors on one device, plus host-side per-slot flags
    (which slots decay, emit or hold padding) so that the slot loop reads
    nothing back from the device."""

    def __init__(self, slots: ChannelSlots, device: torch.device):
        self.device = device
        self.n_slots = slots.n_slots
        self.weight = torch.as_tensor(slots.weight, device=device)[..., None]
        self.ic = torch.as_tensor(slots.ic, device=device)
        self.ci = torch.as_tensor(slots.ci, device=device)
        self.compute = torch.as_tensor(slots.is_compute, device=device)
        self.decay = torch.as_tensor(slots.first_touch & slots.valid,
                                     device=device)[..., None]
        self.emit = torch.as_tensor(slots.emit & slots.valid,
                                    device=device)[..., None]
        self.valid = torch.as_tensor(slots.valid, device=device)[..., None]
        self.decay_at = slots.first_touch.any(0).tolist()
        self.emit_at = slots.emit.any(0).tolist()
        self.padded_at = (~slots.valid).any(0).tolist()
        self._gather: Dict[Tuple[int, int], torch.Tensor] = {}

    def gather_index(self, wi: int, oi: int) -> torch.Tensor:
        """(OC, S, OI) flat index into a (IC*WI) frame: the enable map of
        every slot, ``ifm[ic, ci + o]``."""
        idx = self._gather.get((wi, oi))
        if idx is None:
            o = torch.arange(oi, device=self.device)
            idx = (self.ic * wi + self.ci)[..., None] + o
            self._gather[(wi, oi)] = idx
        return idx


def make_schedule_step(sched: Schedule, lif: LIFParams, oc: int,
                       device=None):
    """Build the per-timestep executor of a static SAOCDS schedule.

    Returns ``one_timestep(v, ifm) -> (v_next, (out_spikes, acc_count))``:
    ``v`` is the (..., OC, OI) membrane state, ``ifm`` the pre-padded
    (..., IC, WI) binary frame, ``acc_count`` the (...) int64 gated
    accumulations of this timestep.  The slot tensors are staged on
    ``device`` once (on the frame's device at first use when ``device``
    is None); the step reads nothing back to the host.
    """
    slots = channel_slots(sched, oc)
    staged: Dict[str, _StagedSlots] = {}
    if device is not None:
        staged[str(torch.device(device))] = _StagedSlots(slots, torch.device(device))
    lif_cache: Dict[Tuple[str, int], Tuple[torch.Tensor, ...]] = {}

    def lif_rows(dev, oi):
        key = (str(dev), oi)
        rows = lif_cache.get(key)
        if rows is None:
            rows = tuple(torch.broadcast_to(torch.as_tensor(p, device=dev),
                                            (oc, oi)).to(torch.float32)
                         for p in (lif.alpha, lif.theta, lif.v_th))
            lif_cache[key] = rows
        return rows

    def one_timestep(v: torch.Tensor, ifm: torch.Tensor):
        st = staged.get(str(ifm.device))
        if st is None:
            st = staged[str(ifm.device)] = _StagedSlots(slots, ifm.device)
        lead = ifm.shape[:-2]
        ic, wi = ifm.shape[-2:]
        oi = v.shape[-1]
        alpha, theta, v_th = lif_rows(ifm.device, oi)
        x = ifm.reshape(-1, ic * wi).to(torch.float32)
        ems = x[:, st.gather_index(wi, oi)]              # (N, OC, S, OI)
        gated = ems.sum(-1).to(torch.int64)               # (N, OC, S)
        acc = (gated * st.compute).sum((1, 2))
        v = v.reshape(-1, oc, oi)
        out = torch.zeros_like(v)
        for s in range(st.n_slots):
            if st.decay_at[s]:       # first touch: load + decay the row
                v = torch.where(st.decay[:, s], alpha * v, v)
            # enable-map gated accumulation (extra slots add 0.0, as in
            # the reference; padding slots leave v as it is)
            v_acc = v + st.weight[:, s] * ems[:, :, s]
            v = torch.where(st.valid[:, s], v_acc, v) if st.padded_at[s] else v_acc
            if st.emit_at[s]:        # fire + soft reset + emit
                spk = (v > v_th).to(v.dtype)
                e = st.emit[:, s]
                v = torch.where(e, v - theta * spk, v)
                out = torch.where(e, spk, out)
        return (v.reshape(*lead, oc, oi),
                (out.reshape(*lead, oc, oi), acc.reshape(lead)))

    return one_timestep


def schedule_interpreter(spikes_t: torch.Tensor, sched: Schedule,
                         lif: LIFParams, oi: int, oc: int,
                         v0: Optional[torch.Tensor] = None):
    """Execute the static SAOCDS schedule over a (T, ..., IC, WI) sequence
    of pre-padded binary frames.

    Returns (out_spikes (T, ..., OC, OI), v_final, counts); ``counts``
    carries the schedule's compute/extra/empty reps and the gated
    accumulations (float32, summed over T exactly in int64).
    """
    t_steps = spikes_t.shape[0]
    v = (torch.zeros(spikes_t.shape[1:-2] + (oc, oi), dtype=torch.float32,
                     device=spikes_t.device) if v0 is None else v0)
    one_timestep = make_schedule_step(sched, lif, oc)
    outs = []
    total = torch.zeros(spikes_t.shape[1:-2], dtype=torch.int64,
                        device=spikes_t.device)
    for x in spikes_t:
        v, (out, acc) = one_timestep(v, x)
        outs.append(out)
        total = total + acc
    counts = {
        "reps_per_timestep": sched.reps,
        "compute_iters": sched.n_compute,
        "extra_iters": sched.n_extra,
        "empty_iters": sched.n_empty,
        "accumulations": total.to(torch.float32),
        "timesteps": t_steps,
    }
    return torch.stack(outs), v, counts
