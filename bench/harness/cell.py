"""A cell as ``BENCHMARK.json`` names it, and the files that make it.

Everything is found by name, so a later change adds a configuration, a
traffic mix, a cell or a metric by adding files and entries alone:

  * ``configs[].file``                the configuration's sizes (JSON)
  * ``bench/traffic/<traffic>.json``  the mix's parameters; its ``driver``
                                      names a module of ``bench/drivers``
  * ``bench/metrics/<metric>.py``     one reader a metric, ``read(run)``;
                                      ``<base>.<kind>`` without a file of
                                      its own reads as ``<base>.py``
                                      (one quantity split by the cells'
                                      end-to-end metric)
  * ``bench/limits/<workload>.json``  the limits that decide ``correct``
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

from bench.harness.env import BENCH, ROOT


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict            # the configuration file's contents
    traffic: Dict           # the traffic file's contents
    end_to_end: List[Dict]  # BENCHMARK.json metrics this cell reports
    per_layer: List[Dict]
    limits: Dict            # name -> limit of each compared number
    root: Path = BENCH

    def driver(self) -> ModuleType:
        return load_module(self.root / "drivers" /
                           f"{self.traffic['driver']}.py")

    def reader(self, metric: str) -> ModuleType:
        path = self.root / "metrics" / f"{metric}.py"
        if not path.is_file() and "." in metric:
            path = path.with_name(f"{metric.rsplit('.', 1)[0]}.py")
        return load_module(path)


def load_module(path: Path) -> ModuleType:
    """A module loaded from its file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    name = "bench_loaded." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench = root / "bench"
    traffic = json.loads((bench / "traffic" /
                          f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in spec["per_layer"]
                           if _reports(m, workload)],
                limits=limits, root=bench)
