"""Everything about a cell, found by the names in ``BENCHMARK.json``.

* a configuration: the file its ``configs`` entry names;
* a traffic mix: ``traffic/<traffic>.json``, read by :mod:`hqrbench.loop`;
  its ``entry`` names the module ``entries/<entry>.py`` (:func:`entry`);
* a per-layer metric: the reader ``metrics/<name>.py`` (``read(view)``);
* a cell's limits: ``limits/<cell>.json``, one per number compared;
* kernel classes: ``kernel_classes/<class>.json`` (:mod:`hqrbench.trace`).

A later cell, mix, entry, metric or class adds files; it edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: "list[dict]"
    per_layer: "list[dict]"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: "dict | None" = None) -> Cell:
    bench = load_benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((ROOT / config["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read(view) -> float | None`` of ``metrics/<metric>.py``."""
    return importlib.import_module(f"hqrbench.metrics.{metric}").read


def entry(name: str):
    """The module ``entries/<name>.py`` (:mod:`hqrbench.entries`)."""
    return importlib.import_module(f"hqrbench.entries.{name}")
