"""Plain PyTorch reference of the paper's SNN as served, written from the
model's equations (paper §IV, Fig. 7, Table II), in float32 with TF32 off.

    iq (B, 2, L)
      normalise per frame to [0, 1]: 0.5 * (iq / (max|iq| + 1e-8) + 1)
      first-order Σ-Δ, T steps: integ += x - y; y = integ >= 0.5
      per conv stage: zero 'same' padding, conv, LIF, max-pool 2
      FC1 + LIF, FC2; logits = sum over T of FC2's currents

    LIF:  v_acc = alpha * v + I;  s = v_acc - v_th > 0;  v = v_acc - theta * s
          alpha = sigmoid(alpha_logit), v starts at 0

Every current is a sum of spike-gated weights taken in one fixed order: for
a conv, input channel by input channel and within one by kernel tap, both
ascending (the paper's output-channel dataflow visits a channel's weights
in that order); for an FC, input by input, ascending.  A product of a spike
and a weight is exact, so the only rounding is each add's.

With bfloat16 weights the model computes as its documentation states
(``repro_torch/models/graph.py``, ``core/lif.py``): the convs keep float32
currents and membranes, with the bf16 LIF parameters promoted and alpha
``1 / (1 + exp(-x))`` whose exp and add round to bf16 and whose divide
stays in f32; each FC's current is summed in tiles of ``fc_tile`` inputs
(the configuration's), each tile's f32 sum rounded to bf16 and added to
the bf16 current with one more rounding (the bf16 weight-mask product's
stated arithmetic, ``repro_torch/kernels/wm_fc.py``); the FC LIF rounds
every op to bf16, alpha included; the readout sums the bf16 currents in
bf16, one rounding an add.

``weights`` lowers the precision of the effective weights before anything
is computed, for the control: ``"tf32"`` keeps 10 mantissa bits (what a
TF32 product reads), ``"fp8"`` rounds to float8 e4m3.

This module imports nothing of the program under test.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

F32 = torch.float32
BF16 = torch.bfloat16


def round_tf32(w: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest (ties away
    from zero, as the tensor cores' conversion rounds)."""
    bits = w.to(F32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(F32)


def lower(w: torch.Tensor, weights: Optional[str]) -> torch.Tensor:
    if weights is None:
        return w
    if weights == "tf32":
        return round_tf32(w).to(w.dtype)
    if weights == "fp8":
        return w.to(torch.float8_e4m3fn).to(w.dtype)
    raise ValueError(f"unknown weight precision {weights!r}")


def encode(iq: torch.Tensor, timesteps: int) -> torch.Tensor:
    """(B, 2, L) float32 -> (T, B, 2, L) spikes in {0, 1}."""
    peak = iq.abs().amax(dim=(-2, -1), keepdim=True)
    x = 0.5 * (iq / (peak + 1e-8) + 1.0)
    integ = torch.zeros_like(x)
    y = torch.zeros_like(x)
    out = []
    for _ in range(timesteps):
        integ = integ + x - y
        y = (integ >= 0.5).to(F32)
        out.append(y)
    return torch.stack(out)


def _alpha(alpha_logit: torch.Tensor, membrane: torch.dtype) -> torch.Tensor:
    """The decay as applied to a membrane of dtype ``membrane``, worked out
    on the host (so that the card and the CPU agree on its bits)."""
    x = alpha_logit.detach().cpu()
    if x.dtype == BF16:
        den = 1.0 + torch.exp(-x)          # each op rounds to bf16
        return 1.0 / den.float() if membrane == F32 else 1.0 / den
    return torch.sigmoid(x.float())


def _lif(currents: torch.Tensor, alpha, theta, v_th) -> torch.Tensor:
    """currents (T, ...) -> spikes (T, ...) in the currents' dtype."""
    v = torch.zeros_like(currents[0])
    spikes = []
    for c in currents:
        v_acc = alpha * v + c
        s = (v_acc - v_th > 0).to(c.dtype)
        v = v_acc - theta * s
        spikes.append(s)
    return torch.stack(spikes)


def conv_currents(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, IC, W) spikes, w (KW, IC, OC) float32 -> (N, OC, W) float32,
    summed input channel by input channel, tap by tap."""
    kw, ic, oc = w.shape
    width = x.shape[-1]
    left = (kw - 1) // 2
    xp = torch.nn.functional.pad(x, (left, kw - 1 - left))
    cur = torch.zeros((x.shape[0], oc, width), dtype=F32, device=x.device)
    for i in range(ic):
        for c in range(kw):
            cur = cur + w[c, i][:, None] * xp[:, i, None, c:c + width]
    return cur


def fc_currents(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, IN) spikes, w (IN, OUT) float32 -> (N, OUT) float32, summed
    input by input; inputs whose weights are all pruned add nothing."""
    cur = torch.zeros((x.shape[0], w.shape[1]), dtype=F32, device=x.device)
    live = torch.nonzero(w.ne(0).any(1)).flatten().tolist()
    for i in live:
        cur = cur + x[:, i, None] * w[i]
    return cur


def fc_currents_in(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
                   tile: int) -> torch.Tensor:
    """The FC current in ``dtype``: float32 summed whole; bf16 as tiles of
    ``tile`` inputs, each tile's f32 sum rounded, the tiles added in bf16."""
    if dtype == F32:
        return fc_currents(x, w.to(F32))
    out = torch.zeros((x.shape[0], w.shape[1]), dtype=dtype, device=x.device)
    for i0 in range(0, w.shape[0], tile):
        part = fc_currents(x[:, i0:i0 + tile], w[i0:i0 + tile].to(F32))
        out = out + part.to(dtype)
    return out


def pool(x: torch.Tensor, p: int) -> torch.Tensor:
    *lead, c, w = x.shape
    w2 = (w // p) * p
    return x[..., :w2].reshape(*lead, c, w2 // p, p).amax(-1)


def forward(model, iq: torch.Tensor, *, weights: Optional[str] = None,
            work: bool = False):
    """Logits (B, n_classes) as float32 for raw I/Q ``iq`` (B, 2, L) on
    its device; with ``work`` also the per-frame gated adds of each layer
    (``{name: (B,) float64}``), counted from this pass's spikes and the
    masks: a conv's adds are, per input spike, the unpruned weights of its
    row of the shifted input (summed over T and positions), an FC's the
    unpruned weights of its input."""
    spec = model.spec
    if spec["readout"] != "current_sum":
        raise ValueError("the reference implements the current_sum readout")
    t_steps = spec["timesteps"]
    b = iq.shape[0]
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counts: Dict[str, torch.Tensor] = {}
    try:
        with torch.no_grad():
            x = encode(iq.to(F32), t_steps)                   # (T, B, 2, L)
            for li, layer in enumerate(model.convs()):
                w = lower(layer.w * layer.mask, weights).to(F32)
                kw, ic, oc = w.shape
                flat = x.reshape(t_steps * b, ic, x.shape[-1])
                if work:
                    counts[f"conv{li + 1}"] = _conv_adds(x, w, b)
                cur = conv_currents(flat, w).reshape(t_steps, b, oc, -1)
                dev = cur.device
                # (OC, 1) parameters broadcast over (B, OC, W)
                s = _lif(cur, _alpha(layer.alpha_logit, F32).to(dev),
                         layer.theta.to(dev).float(), layer.v_th.to(dev).float())
                x = pool(s, spec["pool"])
            dtype = model.dtype
            fcs = model.fcs()
            x = x.reshape(t_steps, b, -1)
            logits = torch.zeros((b, fcs[-1].w.shape[1]), dtype=dtype,
                                 device=iq.device)
            for fi, layer in enumerate(fcs):
                w = lower(layer.w * layer.mask, weights)
                if work:
                    counts[f"fc{fi + 1}"] = (x.ne(0).sum(0).double()
                                             @ w.ne(0).sum(1).double())
                cur = fc_currents_in(x.reshape(t_steps * b, -1), w, dtype,
                                     spec.get("fc_tile", 0))
                cur = cur.reshape(t_steps, b, -1)
                if fi == len(fcs) - 1:
                    for c in cur:
                        logits = logits + c
                    break
                dev = cur.device
                x = _lif(cur, _alpha(layer.alpha_logit, dtype).to(dev),
                         layer.theta.to(dev), layer.v_th.to(dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return (logits.float(), counts) if work else logits.float()


def _conv_adds(x: torch.Tensor, w: torch.Tensor, b: int) -> torch.Tensor:
    """Per-frame gated adds of a conv: x (T, B, IC, W) spikes, w (KW, IC,
    OC) -> (B,) float64."""
    kw, ic, oc = w.shape
    width = x.shape[-1]
    left = (kw - 1) // 2
    xp = torch.nn.functional.pad(x, (left, kw - 1 - left)).double()
    # spikes each (input channel, tap) row of the shifted input carries
    rows = torch.stack([xp[..., c:c + width].sum(dim=(0, -1))
                        for c in range(kw)], dim=-1)          # (B, IC, KW)
    nnz = w.ne(0).sum(-1).double().transpose(0, 1)          # (IC, KW)
    return (rows * nnz).sum(dim=(1, 2))


def forward_blocks(model, iq: torch.Tensor, block: int, **kwargs
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`forward` over ``iq`` in blocks of ``block`` frames (so that
    it fits beside whatever else the device holds); results on the host."""
    outs: List[torch.Tensor] = []
    works: Dict[str, List[torch.Tensor]] = {}
    for s in range(0, iq.shape[0], block):
        got = forward(model, iq[s:s + block], **kwargs)
        if kwargs.get("work"):
            logits, counts = got
            for k, v in counts.items():
                works.setdefault(k, []).append(v.cpu())
        else:
            logits = got
        outs.append(logits.cpu())
    return torch.cat(outs), {k: torch.cat(v) for k, v in works.items()}
