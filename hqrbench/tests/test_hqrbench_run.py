"""The command end to end: without a card it fails and prints no result;
on a card (tests marked ``card``) a small run of each cell is correct and
the TF32 control is not."""

import json
import os
import subprocess
import sys
import time

import pytest

from hqrbench import spec
from hqrbench.control import Control
from hqrbench.loop import Sample, _held_bytes
from hqrbench.run import run_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def test_without_a_card_the_run_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "hqrbench.run", "--workload", CELLS[0],
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA" in out.stderr


def test_held_bytes_count_each_storage_once_and_not_the_programs():
    import torch

    H, alpha = torch.zeros(64, 8), torch.zeros(8)
    own = torch.zeros(64, 8)
    x = torch.zeros(16)
    samples = [Sample(0, x[:8], own, own[0]), Sample(1, x[8:], H, alpha)]
    assert _held_bytes(samples, None) == 4 * (16 + 64 * 8 + 64 * 8 + 8)

    class Program:
        pass

    program = Program()
    program.H, program.alpha = H, alpha
    assert _held_bytes(samples, program) == 4 * (16 + 64 * 8)


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_small_run_on_the_card(cell):
    _card()
    import dhqr_tpu_torch

    c = spec.load_cell(cell)
    c.config = dict(c.config, m=4096, n=512)
    for trace in (False, True):
        r = run_cell(c, 2 ** 36 + 5, 1.0, trace, dhqr_tpu_torch, "cuda",
                     time.perf_counter())
        assert r["correct"] is True, json.dumps(r["check"])
    assert r["device"]["busy_s"] > 0 and r["metrics"]
    r = run_cell(c, 2 ** 36 + 5, 0.5, False, Control, "cuda",
                 time.perf_counter())
    assert r["correct"] is False
