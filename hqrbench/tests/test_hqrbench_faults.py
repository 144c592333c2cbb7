"""A run driven with the timed path broken underneath (the look for a
card skipped, the program on the CPU at a size a test run holds) comes
out not correct: an answer altered where it is produced, a factorization
altered where it is produced, a step that returns its input unchanged,
a call that fails. (Half a batch left out and a skipped exchange between
chips have no place here: one right-hand side per call, one chip.)"""

import dataclasses
import time

import pytest
import torch

import dhqr_tpu_torch
from hqrbench import spec
from hqrbench.run import run_cell

SMALL = {"m": 1024, "n": 256}
# BENCHMARK.json's cells, and lsq131k.resolve: no cell names its mix now
# (its runs spread with the host's speed), but its entry, traffic and
# limits stay for a later cell, so they stay proven here.
BENCH = spec.load_benchmark()
BENCH["workloads"].append({"name": "lsq131k.resolve", "config": "lsq131k_f32",
                           "traffic": "resolve", "chips": 1, "why": "kept"})
CELLS = [w["name"] for w in BENCH["workloads"]]
FACTORED = [c for c in CELLS
            if "factor_err" in spec.load_cell(c, BENCH).limits]


def small(cell: str):
    c = spec.load_cell(cell, BENCH)
    c.config = dict(c.config, **SMALL)
    return c


class _Solve:
    def __init__(self, fact, alter):
        self.fact, self.alter = fact, alter
        self.H, self.alpha = fact.H, fact.alpha

    def solve(self, b):
        return self.alter(self.fact.solve(b))


class AlteredAnswer:
    """The program, with one entry of every solution moved by a
    thousandth of the solution's norm."""

    @staticmethod
    def _alter(x):
        x = x.clone()
        x[x.shape[0] // 2] += 1e-3 * torch.linalg.vector_norm(x)
        return x

    @classmethod
    def lstsq(cls, A, b, **kw):
        return cls._alter(dhqr_tpu_torch.lstsq(A, b, **kw))

    @classmethod
    def qr(cls, A, **kw):
        return _Solve(dhqr_tpu_torch.qr(A, **kw), cls._alter)


class AlteredFactor:
    """The program, with one stored reflector entry of every factorization
    altered (its solves use the altered factorization)."""

    @staticmethod
    def qr(A, **kw):
        fact = dhqr_tpu_torch.qr(A, **kw)
        H = fact.H.clone()
        H[H.shape[0] - 1, H.shape[1] // 2] += 1e-3
        return dataclasses.replace(fact, H=H)

    lstsq = staticmethod(dhqr_tpu_torch.lstsq)


class Unchanged:
    """A step that returns its input unchanged: ``qr`` hands back A as its
    reflectors (R's diagonal A's), ``lstsq`` and every solve b's head."""

    @staticmethod
    def lstsq(A, b, **kw):
        return b[:A.shape[1]].clone()

    @staticmethod
    def qr(A, **kw):
        fact = dhqr_tpu_torch.qr(A, **kw)
        fact = dataclasses.replace(fact, H=A.clone(),
                                   alpha=A.diagonal().clone())
        return _Solve(fact, lambda x: x)


class Raises:
    """The program, raising in every call after the cell's warm-up calls
    (its ``lstsq``, or the solve of a factorization it made)."""

    def __init__(self, warm: int):
        self.warm, self.calls = warm, 0

    def _count(self):
        self.calls += 1
        if self.calls > self.warm:
            raise RuntimeError("planted")

    def lstsq(self, A, b, **kw):
        self._count()
        return dhqr_tpu_torch.lstsq(A, b, **kw)

    def qr(self, A, **kw):
        def solve(x):
            self._count()
            return x
        return _Solve(dhqr_tpu_torch.qr(A, **kw), solve)


class NonFinite:
    @staticmethod
    def lstsq(A, b, **kw):
        x = dhqr_tpu_torch.lstsq(A, b, **kw)
        return torch.full_like(x, float("nan"))

    @staticmethod
    def qr(A, **kw):
        return _Solve(dhqr_tpu_torch.qr(A, **kw),
                      lambda x: torch.full_like(x, float("inf")))


def _run(cell, prog):
    return run_cell(small(cell), 2 ** 34 + 3, 0.3, False, prog, "cpu",
                    time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(cell):
    r = _run(cell, AlteredAnswer)
    assert r["failed"] == 0 and r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["check"].values())


@pytest.mark.parametrize("cell", FACTORED)
def test_an_altered_factorization_is_not_correct(cell):
    r = _run(cell, AlteredFactor)
    assert r["correct"] is False
    c = r["check"]["factor_err"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_returning_its_input_is_not_correct(cell):
    r = _run(cell, Unchanged)
    assert r["correct"] is False
    # every number fails (a NaN fails too)
    assert not any(c["value"] <= c["limit"] for c in r["check"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_failed_calls_are_counted_and_not_correct(cell):
    warm = int(spec.load_cell(cell, BENCH).traffic["warm_calls"])
    r = _run(cell, Raises(warm))
    assert r["attempted"] > 0 and r["failed"] == r["attempted"]
    assert r["correct"] is False
    assert "planted" in r["notes"]["errors"][0]
    r = _run(cell, NonFinite)
    assert r["failed"] == r["attempted"] > 0 and r["correct"] is False
