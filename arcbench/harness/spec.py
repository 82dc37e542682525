"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root names the cells and metrics.  Everything
that belongs to one of them is a file of its own under ``arcbench/``:

  configs/<config>.json      the model as it is run and its deployment
  traffic/<traffic>.json     a traffic mix: its driver and its parameters
  workloads/<cell>.json      a cell's own settings: its trace plan and the
                             limits of its correctness numbers
  metrics/<metric>.py        one per-layer metric's reader

A cell, configuration, mix or metric is added by adding such files and
``BENCHMARK.json`` entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str                      # "end_to_end" | "per_layer"
    moves: Optional[str] = None
    layer: Optional[str] = None
    workloads: Optional[List[str]] = None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                   # configs/<config>.json
    traffic: dict                  # traffic/<traffic>.json
    settings: dict                 # workloads/<cell>.json
    end_to_end: List[Metric]       # the metrics this cell reports untraced
    per_layer: List[Metric]        # ... and traced

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def metrics(bench: dict) -> List[Metric]:
    out = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            out.append(Metric(name=m["name"], unit=m["unit"],
                              better=m["better"], source=m["source"],
                              kind=kind, moves=m.get("moves"),
                              layer=m.get("layer"),
                              workloads=m.get("workloads")))
    return out


def cell(name: str, bench: Optional[dict] = None,
         bench_dir: Path = BENCH) -> Cell:
    """The cell ``name`` with its files and the metrics it reports: an
    end-to-end metric whose ``workloads`` list it (or that has none, as
    ``setup_s``), and every per-layer metric that moves one of those and
    lists it (or lists nothing)."""
    bench = bench if bench is not None else benchmark(bench_dir.parent)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(bench_dir / "configs" / f"{entry['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    settings = load_json(bench_dir / "workloads" / f"{name}.json")
    ms = metrics(bench)

    def listed(m: Metric) -> bool:
        return m.workloads is None or name in m.workloads

    e2e = [m for m in ms if m.kind == "end_to_end" and listed(m)]
    names = {m.name for m in e2e}
    per = [m for m in ms if m.kind == "per_layer" and m.moves in names
           and listed(m)]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, settings=settings, end_to_end=e2e,
                per_layer=per)


def metric_module(name: str, bench_dir: Path = BENCH) -> ModuleType:
    """``metrics/<name>.py`` loaded as a module (its file name may hold
    dots, so it is loaded by path)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"arcbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_module(kind: str) -> ModuleType:
    return importlib.import_module(f"arcbench.drivers.{kind}")


def per_layer_values(cell: Cell, readings: Dict,
                     bench_dir: Path = BENCH) -> Dict[str, dict]:
    """Each per-layer metric of ``cell`` read from ``readings``; a reader
    that finds nothing returns None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_module(m.name, bench_dir).compute(readings)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out
