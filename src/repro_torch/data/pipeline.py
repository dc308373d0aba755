"""Input pipelines: host-side generation -> Σ-Δ encoding -> device.

Port of ``repro/data/pipeline.py``: the batched Σ-Δ encoders (a numpy one
for the host and a torch one that runs wherever its input lies; the serve
engine runs it on the card, ahead of the fused kernel), both giving the
reference's bits exactly, and :class:`SpikeBatchPipeline`, the background
producer of encoded RadioML batches, and the language-model zoo's
synthetic token stream (:func:`lm_token_batches`, numpy, element for
element the reference's).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.channel.scenario import apply_scenario_np
from repro_torch.core.encoder import encode_frames
from repro_torch.data.radioml import RadioMLDataset
from repro_torch.device import resolve_device

__all__ = ["sigma_delta_encode_np", "sigma_delta_encode_batch",
           "SpikeBatchPipeline", "lm_token_batches"]


def sigma_delta_encode_np(iq: np.ndarray, osr: int) -> np.ndarray:
    """iq: (B, 2, L) float -> (B, T=osr, 2, L) float32 in {0, 1}."""
    peak = np.max(np.abs(iq), axis=(-2, -1), keepdims=True)
    x = 0.5 * (iq / (peak + 1e-8) + 1.0)
    integ = np.zeros_like(x)
    y_prev = np.zeros_like(x)
    bits = np.empty((osr,) + x.shape, dtype=np.float32)
    for t in range(osr):
        integ = integ + x - y_prev
        y_prev = (integ >= 0.5).astype(np.float32)
        bits[t] = y_prev
    return np.moveaxis(bits, 0, 1)


def sigma_delta_encode_batch(iq: torch.Tensor, osr: int) -> torch.Tensor:
    """(B, 2, L) -> (B, T, 2, L), on the device ``iq`` lies on."""
    return encode_frames(iq, osr).movedim(0, 1)


class SpikeBatchPipeline:
    """Background-threaded batch producer with bounded-queue backpressure.

    A thread generates RadioML batches and Σ-Δ encodes them (numpy) while
    the device computes; the queue depth ``prefetch`` is the straggler
    budget.  Batches are ``(frames (B, T, 2, L), labels (B,), snrs (B,))``
    as numpy, or with frames and labels as tensors on ``device`` when one
    is given (the reference's ``sharding``).

    ``scenario`` (a :data:`repro_torch.channel.SCENARIOS` name or a
    :class:`~repro_torch.channel.ChannelScenario`) inserts a
    channel-augmentation stage: the generator emits clean modulated frames
    and the producer runs them through the scenario's channel at each
    frame's SNR before Σ-Δ encoding, deterministic in ``(seed, batch
    index, scenario)``.  The channel runs on ``device``: the card unless
    ``device="cpu"``.

    ``close()`` ends the stream for consumers too: a sentinel is left in
    the queue so a consumer blocked in (or arriving at) ``__next__`` gets
    ``StopIteration`` instead of hanging on a queue whose producer has
    stopped.
    """

    _CLOSED = object()  # sentinel: producer stopped, stream is over

    def __init__(
        self,
        batch_size: int,
        osr: int = 8,
        seed: int = 0,
        snr_db: Optional[float] = None,
        prefetch: int = 4,
        device=None,
        scenario=None,
    ):
        self.osr = osr
        self.device = None if device is None else resolve_device(device)
        self._scenario = scenario
        self._seed = seed
        # the channel stage's device, resolved up front so a missing card
        # raises here and not in the producer thread
        self._channel_device = (None if scenario is None
                                else resolve_device(device))
        self._ds = iter(RadioMLDataset(batch_size, seed=seed, snr_db=snr_db,
                                       apply_channel=scenario is None))
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            iq, labels, snrs = next(self._ds)
            if self._scenario is not None:
                iq = apply_scenario_np(self._scenario, iq, snrs,
                                       self._seed + step,
                                       device=self._channel_device)
            step += 1
            frames = sigma_delta_encode_np(iq, self.osr)
            while not self._stop.is_set():
                try:
                    self._q.put((frames, labels, snrs), timeout=1.0)
                    break
                except queue.Full:
                    continue   # the consumer is slow: backpressure holds

    def __iter__(self) -> Iterator:
        return self

    def _put_sentinel(self) -> None:
        """Non-blocking sentinel publish: never wait on a full queue (a
        straggler producer could have refilled it), make room instead."""
        while True:
            try:
                self._q.put_nowait(self._CLOSED)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass

    def __next__(self):
        while True:
            item = self._q.get()
            if item is self._CLOSED:
                # leave the sentinel for siblings, then end the stream
                self._put_sentinel()
                raise StopIteration
            if self._stop.is_set():
                # a producer that outlived close()'s join can land a batch
                # behind the sentinel: once closed, stale batches are dropped
                continue
            frames, labels, snrs = item
            if self.device is not None:
                frames = torch.from_numpy(frames).to(self.device)
                labels = torch.from_numpy(labels).to(self.device)
            return frames, labels, snrs

    def close(self):
        """Stop the producer and end the stream for all consumers."""
        self._stop.set()
        # unblock a producer stuck in put(), then let it exit
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
        # drain what the producer enqueued while exiting, so the sentinel
        # is what consumers reach next
        try:
            while True:
                if self._q.get_nowait() is self._CLOSED:
                    break
        except queue.Empty:
            pass
        self._put_sentinel()


def lm_token_batches(
    batch: int, seq_len: int, vocab: int, seed: int = 0
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic Zipf-ish token stream: yields (tokens, labels)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq_len + 1), p=probs).astype(np.int32)
        yield toks[:, :-1], toks[:, 1:]
