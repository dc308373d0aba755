"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the harness reads the
configuration's ``file`` and ``amcbench/traffic/<traffic>.json``, both under
the root it is given.  The configuration's model group sets the frames'
length (``input_width``) and the network; the mix's optional ``frames``
names the modulation set the pool draws (``frames.FRAME_SETS``; absent:
``"radioml2016.10a"``).  A metric ``<family>[.<suffix>]`` is read by
``amcbench/metrics/<family>.py`` (its ``read(run, name)``); a kernel's
roofline ``<kernel>_roofline`` counts its work in
``amcbench/work/<kernel>.py``.  Adding a cell, a mix, a configuration of
any SNN the program serves (any frame length, stack of convs and FCs, or
number of classes) or a metric adds files and entries; no file here
changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
from typing import Any, Dict, List

from amcbench.frames import DEFAULT_SET, FRAME_SETS

TRAFFIC_DIR = pathlib.Path("amcbench") / "traffic"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    workloads: List[str] | None
    moves: str | None = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads

    @property
    def family(self) -> str:
        return self.name.split(".", 1)[0]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _metric(d: Dict[str, Any]) -> Metric:
    return Metric(name=d["name"], unit=d["unit"], workloads=d.get("workloads"),
                  moves=d.get("moves"))


def load_benchmark(root: pathlib.Path) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def read_json(path: pathlib.Path) -> Dict[str, Any]:
    return json.loads(path.read_text())


def resolve(root: pathlib.Path, workload: str) -> Cell:
    """The cell ``workload`` of the root's ``BENCHMARK.json``, with its
    configuration and traffic read and its metrics listed."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(root / TRAFFIC_DIR / f"{w['traffic']}.json")
    frames = traffic.get("frames", DEFAULT_SET)
    if frames not in FRAME_SETS:
        raise ValueError(f"traffic {w['traffic']!r} names the frame set "
                         f"{frames!r}; the generator has {sorted(FRAME_SETS)}")
    e2e = [m for m in map(_metric, bench["end_to_end"]) if m.applies_to(workload)]
    per_layer = [m for m in map(_metric, bench["per_layer"])
                 if m.applies_to(workload)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def reader(metric: Metric):
    """The module that reads ``metric``: ``amcbench.metrics.<family>``."""
    return importlib.import_module(f"amcbench.metrics.{metric.family}")


def arrivals(kind: str):
    """The arrival process ``amcbench/traffic/arrivals_<kind>.py``."""
    return importlib.import_module(f"amcbench.traffic.arrivals_{kind}")


def work(kernel: str):
    """The work counter of a kernel form: ``amcbench/work/<kernel>.py``."""
    return importlib.import_module(f"amcbench.work.{kernel}")
