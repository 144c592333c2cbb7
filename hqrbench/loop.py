"""The one traffic loop: a closed loop with one caller, shaped by a
traffic file (``traffic/<mix>.json``).

The file's ``entry`` names the module ``entries/<entry>.py`` that says
what each call is: its set-up, its draw, the call and its spans
(``hqrbench.lstsq``, ``hqrbench.factor``, ``hqrbench.solve``). The loop
names no entry.

Every input is drawn on the device from (seed, tag, index) with its own
generator state, so the same seed gives the same inputs and the judge can
draw them again. Around the entry's spans each call runs in
``hqrbench.draw`` (the draw and a synchronize, outside the call's
latency) and ``hqrbench.wait`` (the synchronize that ends the call's
latency, and the tally of non-finite results). The warm-up calls take the
same path, so every kernel a call launches is loaded before the window.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import time

import torch
from torch.profiler import record_function

from hqrbench import spec


def derive(seed: int, tag: str, index: int = 0) -> int:
    """A 63-bit generator seed for input ``tag`` number ``index`` of a run
    seeded ``seed`` (any whole number)."""
    digest = hashlib.blake2b(f"{seed}/{tag}/{index}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class Inputs:
    """A and b of a configuration, uniform on [0, 1), drawn on ``device``."""

    def __init__(self, config: dict, seed: int, device):
        self.m, self.n = int(config["m"]), int(config["n"])
        self.dtype = getattr(torch, config["dtype"])
        self.seed = seed
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def matrix(self, tag: str, index: int) -> torch.Tensor:
        self.gen.manual_seed(derive(self.seed, f"A.{tag}", index))
        return torch.rand((self.m, self.n), generator=self.gen,
                          device=self.device, dtype=self.dtype)

    def rhs(self, tag: str, index: int) -> torch.Tensor:
        self.gen.manual_seed(derive(self.seed, f"b.{tag}", index))
        return torch.rand((self.m,), generator=self.gen, device=self.device,
                          dtype=self.dtype)


@dataclasses.dataclass
class Sample:
    """A finished call kept for the judge: its index, x, and the stored
    reflectors of the factorization it used (None where the entry returns
    none)."""

    index: int
    x: torch.Tensor
    H: "torch.Tensor | None" = None
    alpha: "torch.Tensor | None" = None


@dataclasses.dataclass
class Window:
    start: float
    end: float
    latencies: "list[float]"
    attempted: int
    failed: int
    samples: "list[Sample]"
    errors: "list[str]"
    peak_bytes: int = 0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def completed(self) -> int:
        return len(self.latencies)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _held_bytes(samples, program) -> int:
    """Bytes of the storages the samples hold, less those the program
    holds itself (``program``: its set-up factorization, or None)."""
    seen = set()
    if program is not None:
        seen = {t.untyped_storage().data_ptr()
                for t in (program.H, program.alpha)}
    total = 0
    for s in samples:
        for t in (s.x, s.H, s.alpha):
            if t is None:
                continue
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
    return total


class _Peak:
    """The device's allocation peak, less what the judge's samples held
    while it was reached: each stretch in which the samples are the same
    is read, less their bytes, when they change and at the end."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.value = 0

    def read(self, held: int) -> None:
        if self.cuda:
            self.value = max(self.value, torch.cuda.max_memory_allocated(
                self.device) - held)

    def reset(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)


class TrafficLoop:
    """Drives ``prog`` (the program's package, or a stand-in with the same
    ``qr`` / ``lstsq`` / ``fact.solve``) through one cell's traffic."""

    def __init__(self, config: dict, traffic: dict, prog, seed: int, device):
        self.entry = spec.entry(traffic["entry"])
        self.traffic = traffic
        self.prog = prog
        self.seed = seed
        self.device = torch.device(device)
        self.options = dict(config.get("options", {}))
        self.inputs = Inputs(config, seed, self.device)
        self.fact = None

    def setup(self, marks: "dict | None" = None, t0: float = 0.0) -> None:
        """The entry's set-up, then the warm-up calls, on inputs of their
        own; ``marks`` gets the time since ``t0`` at which each step
        ended."""
        marks = {} if marks is None else marks
        self.entry.setup(self)
        _sync(self.device)
        marks["setup_entry"] = time.perf_counter() - t0
        for j in range(int(self.traffic["warm_calls"])):
            self._one("warm", j)
            marks[f"warm_{j}"] = time.perf_counter() - t0

    def _one(self, tag: str, index: int, bad: "torch.Tensor | None" = None):
        """Draw, call, wait: ``(x, fact, latency in s)``; a non-finite x
        adds one to ``bad`` (on the device, read after the window)."""
        with record_function("hqrbench.draw"):
            drawn = self.entry.draw(self, tag, index)
            _sync(self.device)
        t0 = time.perf_counter()
        x, fact = self.entry.call(self, *drawn)
        with record_function("hqrbench.wait"):
            _sync(self.device)
            t1 = time.perf_counter()
            if bad is None:
                bad = torch.zeros((), dtype=torch.int64, device=self.device)
            bad += (~torch.isfinite(x)).any()
        return x, fact, t1 - t0

    def window(self, seconds: "float | None" = None,
               calls: "int | None" = None) -> Window:
        """Calls until ``seconds`` have passed (the last call started
        before then runs to its end) or ``calls`` have been made. The
        window's ``peak_bytes`` is the device's peak since the process
        started, less the samples kept for the judge."""
        k = int(self.traffic["check_calls"])
        rng = random.Random(derive(self.seed, "sample"))
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        latencies, samples, errors = [], [], []
        attempted = failed = held = 0
        peak = _Peak(self.device)
        start = time.perf_counter()
        while True:
            if calls is not None and attempted >= calls:
                break
            if seconds is not None and time.perf_counter() - start >= seconds:
                break
            index = attempted
            attempted += 1
            try:
                x, fact, latency = self._one("call", index, bad)
            except Exception as err:  # a failed call is counted, not fatal
                failed += 1
                if len(errors) < 3:
                    errors.append(f"call {index}: {type(err).__name__}: {err}")
                continue
            latencies.append(latency)
            # reservoir sample of the finished calls, from the seed
            n_done = len(latencies)
            slot = n_done - 1 if n_done <= k else rng.randrange(n_done)
            if slot < k:
                peak.read(held)
                s = Sample(index, x, *((fact.H, fact.alpha) if fact is not None
                                       else (None, None)))
                if slot < len(samples):
                    samples[slot] = s
                else:
                    samples.append(s)
                del s
                held = _held_bytes(samples, self.fact)
                peak.reset()
            del x, fact
        _sync(self.device)
        end = time.perf_counter()
        peak.read(held)
        nonfinite = int(bad.item())
        return Window(start=start, end=end, latencies=latencies,
                      attempted=attempted, failed=failed + nonfinite,
                      samples=samples, errors=errors, peak_bytes=peak.value)
