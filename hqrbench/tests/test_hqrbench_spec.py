"""BENCHMARK.json against the benchmark's contract, and everything a cell
names found by that name: configuration, traffic, limits, readers, kernel
classes."""

import json
import re
from pathlib import Path

import pytest

from hqrbench import spec, trace

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hqrbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert LINE.match(c["source"]) and c["source"].startswith("https://")
        assert LINE.match(c["why"])
        assert c["file"].startswith("hqrbench/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert body["precision"] == "highest" and body["dtype"] == "float32"


def test_workloads():
    assert len(set(CELLS)) == len(CELLS)
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= \
        max(1, len(CELLS) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"setup_s", "gflops", "p90_solve_ms"} <= set(e2e)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for cell in CELLS:
        c = spec.load_cell(cell)
        assert "setup_s" in {m["name"] for m in c.end_to_end}
        assert len(c.end_to_end) >= 2 and c.per_layer


# BENCHMARK.json's cells, and lsq131k.resolve, whose files stay for a
# later cell.
KEPT = {"name": "lsq131k.resolve", "config": "lsq131k_f32",
        "traffic": "resolve", "chips": 1, "why": "kept"}


@pytest.mark.parametrize("cell", CELLS + [KEPT["name"]])
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell, dict(BENCH, workloads=BENCH["workloads"]
                                  + [KEPT]))
    entry = spec.entry(c.traffic["entry"])
    for name in ("flops", "setup", "draw", "call", "matrix_of"):
        assert callable(getattr(entry, name))
    assert entry.flops(c.config["m"], c.config["n"]) > 0
    for key in ("warm_calls", "check_calls", "trace_seconds"):
        assert c.traffic[key] > 0
    assert c.limits and set(c.limits) <= {"factor_err", "x_err", "fit_err"}
    assert all(0 < v < 1 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert c.config["m"] >= c.config["n"] > 0


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell")
    with pytest.raises(ModuleNotFoundError):
        spec.entry("no_such_entry")


def test_every_file_under_the_folder_is_named_from_a_name():
    for path in Path(spec.HERE).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_kernel_classes():
    classes = {c for c, _ in trace.load_classes()}
    assert {"panel", "gemm", "trsm"} <= classes
