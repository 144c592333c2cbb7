"""What the harness and the reference load: no JAX, no JAX package (top
names compared whole: ``dhqr_tpu_torch`` is not ``dhqr_tpu``), and the
reference nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from hqrbench import run, spec

HARNESS = ["hqrbench.run", "hqrbench.loop", "hqrbench.check",
           "hqrbench.control", "hqrbench.spec", "hqrbench.trace",
           "hqrbench.work", "hqrbench.stats", "hqrbench.reference.householder"]
METRICS = [f"hqrbench.metrics.{p.stem}"
           for p in sorted((spec.HERE / "metrics").glob("*.py"))
           if p.stem != "__init__"]
ENTRIES = [f"hqrbench.entries.{p.stem}"
           for p in sorted((spec.HERE / "entries").glob("*.py"))
           if p.stem != "__init__"]


def _loaded(modules):
    code = ("import json, sys\n"
            f"for m in {modules!r}: __import__(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_run_loads_no_jax():
    tops = _loaded(HARNESS + METRICS + ENTRIES
                   + ["dhqr_tpu_torch"])
    assert "dhqr_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN), tops & set(run.FORBIDDEN)


def test_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("dhqr_tpu", None)
        sys.modules["dhqr_tpu_torch_lookalike"] = sys
        assert "dhqr_tpu" not in run.forbidden_modules()
        sys.modules["dhqr_tpu.ops"] = sys
        assert "dhqr_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_the_reference_imports_nothing_of_the_program():
    tops = _loaded(["hqrbench.reference.householder"])
    assert not tops & {"dhqr_tpu_torch", *run.FORBIDDEN}
    for path in Path(spec.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in {"__future__", "contextlib",
                                              "torch"}, (path, name)


def test_no_harness_file_reads_the_old_harness():
    for path in spec.HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for old in ("chip_smoke", "bench.py", "benchmarks/", "BENCH_",
                    "panel_ab"):
            assert old not in text, (path, old)
