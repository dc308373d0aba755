"""Launch counts of the kernel wrappers, true under CUDA-graph replay.

Each wrapper calls :func:`count_launch` where it launches its kernel, and
nowhere else.  While the calling thread captures a CUDA graph (inside
:func:`recording`), a launch does not run: it is recorded for that graph
instead of counted, and whoever replays the graph adds the record once a
replay (:func:`add_launches`).  Counts made by other threads during a
capture land in the counters, never in the record.  A wrapper may also
hand :func:`count_launch` what it launched with (the whole-network
kernel's ``FusedLaunch``): a capture keeps it in the record's
``details``, so the replaying step knows the launch without planning it
again (:func:`record_details`).
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Counter, Iterator

__all__ = ["count_launch", "recording", "add_launches", "record_counts",
           "record_details"]

_lock = threading.Lock()
_local = threading.local()


class _Record(collections.Counter):
    """wrapper -> launches of one capture, and the ``details`` they noted."""

    def __init__(self):
        super().__init__()
        self.details = []


def count_launch(wrapper, detail=None) -> None:
    """One launch of ``wrapper``'s kernel by the calling thread, made with
    ``detail`` (kept only by a capture's record)."""
    record = getattr(_local, "record", None)
    if record is not None:
        record[wrapper] += 1
        if detail is not None:
            record.details.append(detail)
        return
    with _lock:
        wrapper.launches += 1


@contextlib.contextmanager
def recording() -> Iterator[Counter]:
    """Record the calling thread's launches (wrapper -> n) instead of
    counting them, for the graph it is capturing."""
    if getattr(_local, "record", None) is not None:
        raise RuntimeError("launch recording does not nest")
    record = _Record()
    _local.record = record
    try:
        yield record
    finally:
        _local.record = None


def add_launches(record: Counter) -> None:
    """Count one replay of a graph whose capture recorded ``record``."""
    with _lock:
        for wrapper, n in record.items():
            wrapper.launches += n


def record_counts(record: Counter) -> dict:
    """A record as {kernel name: launches}."""
    return {wrapper.__name__: n for wrapper, n in record.items()}


def record_details(record: Counter) -> tuple:
    """What a record's launches noted, in launch order."""
    return tuple(record.details)
