"""A rank launcher for the tests and ``chip_smoke.py``: run one function on
P ranks, each its own process, over a fresh process group. The library
never calls it.

    results = run_ranks(fn, 2, backend="gloo", device="cpu", seed=0)

spawns P processes (the ``spawn`` start method: a child imports torch and
the module that defines ``fn``, nothing of its parent's state), joins them
to a group through a ``FileStore`` in a fresh temporary directory (no TCP
port to collide with another run on the host), sets this rank's CUDA
device when ``device`` is a card (one intra-op thread per rank on the
CPU), and returns every rank's
``fn(device=device, **kwargs)`` in rank order (it must pickle). A rank
that raises makes ``run_ranks`` raise with that rank's traceback, and so
does a run that outlives ``timeout_s``; the other ranks are then
terminated. Every process it starts has ended when it returns or raises.

:func:`run_calls` is a worker for such runs: it calls the port's entry
points on this rank's mesh, case by case.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue as _queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

from dhqr_tpu_torch.utils.device import resolve_device


def _rank_main(fn, rank, size, backend, device, tmp, timeout_s, results):
    import torch.distributed as dist

    try:
        with open(os.path.join(tmp, "kwargs.pkl"), "rb") as f:
            kwargs = pickle.load(f)  # written by run_ranks for this run
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # the ranks are the parallelism; more threads oversubscribe
            torch.set_num_threads(1)
        store = dist.FileStore(os.path.join(tmp, "store"), size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(device=device, **kwargs)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, size: int, backend: str = "gloo", device=None,
              timeout_s: float = 120.0, **kwargs) -> list:
    """``[fn(device=device, **kwargs) on rank r for r in range(size)]``,
    each rank a spawned process in a ``backend`` group of ``size`` ranks,
    all on ``device`` (a CPU group, or ranks sharing one card; None means
    the card, as everywhere in the port, and raises without one); raises on
    the first rank that raises, and after ``timeout_s`` seconds."""
    device = resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dhqr_ranks_")
    # The arguments go through a file: a large argument of Process would
    # block each start() until that child has imported torch and read it.
    with open(os.path.join(tmp, "kwargs.pkl"), "wb") as f:
        pickle.dump(kwargs, f)
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main,
        args=(fn, r, size, backend, str(device), tmp, timeout_s, results),
        daemon=True)
        for r in range(size)]
    out = [None] * size
    try:
        for p in procs:
            p.start()
        # dhqr: ignore[DHQR008] bounds a REAL hang of the spawned rank processes — wall time is the point
        deadline = time.monotonic() + timeout_s
        pending = set(range(size))
        while pending:
            # dhqr: ignore[DHQR008] same hang bound
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(pending)} of {size} did not finish in "
                    f"{timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=0.2)
            except _queue.Empty:
                dead = [r for r in pending if procs[r].exitcode is not None]
                if dead:
                    time.sleep(0.5)  # a result put just before exit
                    if results.empty():
                        raise RuntimeError(
                            f"rank {dead[0]} of {size} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {size} raised:\n{value}")
            out[rank] = value
            pending.discard(rank)
        for p in procs:
            # dhqr: ignore[DHQR008] same hang bound, for the joins
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def rank_backend(device, size: int) -> "tuple[str, bool]":
    """``(backend, per_card)`` for ``size`` ranks on ``device`` (a
    resolved ``torch.device``): NCCL with a card per rank when there are
    that many cards, else gloo (the CPU, or ranks sharing the card)."""
    per_card = device.type == "cuda" and size > 1 \
        and torch.cuda.device_count() >= size
    return ("nccl" if per_card else "gloo"), per_card


class Placeholder:
    """An argument of a :func:`run_calls` case that the rank fills in: its
    column mesh, its row mesh, a pod mesh, or the previous step's
    value."""

    def __init__(self, name: str):
        self.name = name


COLS = Placeholder("cols")
ROWS = Placeholder("rows")
PREV = Placeholder("prev")


class AsTensor:
    """A numpy array that a :func:`run_calls` step takes as a tensor on
    the rank's device (for the wire seam's functions)."""

    def __init__(self, array):
        self.array = array


def pod(topo: str) -> Placeholder:
    """This rank's :func:`~dhqr_tpu_torch.parallel.pod_mesh` of ``topo``
    (``"2x2"``), made at its first use (every rank reaches it in the same
    case, so the subgroups are made in one order)."""
    return Placeholder(f"pod:{topo}")


def mesh_summary(mesh) -> dict:
    """What a mesh is, for a caller in another process (a process group
    does not pickle): its axes and shape, this rank, and the default-group
    ranks of its group and of a pod mesh's two tier groups."""
    def ranks(m):
        return [m.global_rank(r) for r in range(m.size)]

    out = {"axis_names": tuple(mesh.axis_names), "shape": dict(mesh.shape),
           "rank": mesh.rank, "size": mesh.size, "ranks": ranks(mesh)}
    if getattr(mesh, "ici_mesh", None) is not None:
        out["ici_ranks"] = ranks(mesh.ici_mesh)
        out["dcn_ranks"] = ranks(mesh.dcn_mesh)
    return out


def _numpy(value):
    import dataclasses

    from dhqr_tpu_torch.parallel.mesh import ColumnMesh

    if isinstance(value, torch.Tensor):
        return value.detach().resolve_conj().cpu().numpy()
    if isinstance(value, ColumnMesh):
        return mesh_summary(value)
    if isinstance(value, (tuple, list)):
        return type(value)(_numpy(v) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclasses.replace(value, **{
            f.name: _numpy(getattr(value, f.name))
            for f in dataclasses.fields(value) if f.init})
    return value


def run_calls(device, cases):
    """Worker: run each case on this rank and return, per case,
    ``("ok", value)`` with tensors as numpy arrays (in lists, tuples and
    dataclasses too), or ``("raised",
    exception type name, message)``.

    A case is a list of steps ``(target, args, kwargs)``: ``target`` names
    a function of :mod:`dhqr_tpu_torch.parallel` or :mod:`dhqr_tpu_torch`
    (a dotted name: of its submodule, e.g. ``"interop.to_numpy"``), or,
    starting with ``"."``, a method of the previous step's value. A mesh
    in the value comes back as its :func:`mesh_summary`.
    :data:`COLS` / :data:`ROWS` in the arguments become this rank's column
    / row mesh on ``device``, :func:`pod` a pod mesh, :data:`PREV` the
    previous step's value; numpy arrays go in as they are, and an
    :class:`AsTensor` as a tensor on ``device``. A case may
    also be a dict ``{"steps": [...], "faults": FaultConfig or None,
    "census": bool, "armor": ArmorConfig or None}``: its steps run under
    that fault schedule (``faults.injected``), with ``census`` an ``"ok"``
    outcome carries a third element, the wire census's entries, and with
    ``armor`` the steps run armed (``armor.armored``) and the outcome ends
    in the seam's report (:func:`_armor_report`). The armor seam's
    degraded labels and wire trips outlive a case, as in a process."""
    import contextlib
    import importlib

    import dhqr_tpu_torch
    from dhqr_tpu_torch import armor, faults, parallel
    from dhqr_tpu_torch.parallel import wire

    meshes = {"cols": parallel.column_mesh(device=device),
              "rows": parallel.row_mesh(device=device)}

    def mesh_of(name):
        if name not in meshes:  # "pod:<topo>"
            meshes[name] = parallel.pod_mesh(topo=name[4:],
                                             device=device)[0]
        return meshes[name]

    def bind(x):
        if isinstance(x, Placeholder):  # compared by name: it was pickled
            return value if x.name == PREV.name else mesh_of(x.name)
        if isinstance(x, AsTensor):
            return torch.as_tensor(x.array, device=device)
        if isinstance(x, (tuple, list)):
            return type(x)(bind(v) for v in x)
        if isinstance(x, dict):
            return {k: bind(v) for k, v in x.items()}
        return x

    out = []
    for case in cases:
        if not isinstance(case, dict):
            case = {"steps": case}
        steps = case["steps"]
        value = None
        scope = faults.injected(case["faults"]) if case.get("faults") \
            else contextlib.nullcontext()
        armed = armor.armored(case["armor"]) if case.get("armor") \
            else contextlib.nullcontext()
        try:
            with armed as state, scope, wire.census() as seen:
                try:
                    for target, args, kwargs in steps:
                        args, kwargs = bind(args), bind(kwargs)
                        if target.startswith("."):
                            value = getattr(value, target[1:])(*args,
                                                               **kwargs)
                            continue
                        path, _, name = target.rpartition(".")
                        mod = importlib.import_module(
                            f"dhqr_tpu_torch.{path}") if path else \
                            parallel if hasattr(parallel, name) else \
                            dhqr_tpu_torch
                        value = getattr(mod, name)(*args, **kwargs)
                except Exception as exc:
                    outcome = ("raised", type(exc).__name__, str(exc))
                    if state is not None:
                        outcome += (_armor_report(state, exc),)
                    out.append(outcome)
                    continue
            outcome = ("ok", _numpy(value))
            if case.get("census"):
                outcome += (seen.entries,)
            if state is not None:
                outcome += (_armor_report(state),)
            out.append(outcome)
        except Exception as exc:  # the case's outcome, for the caller
            out.append(("raised", type(exc).__name__, str(exc)))
    return out


def _armor_report(state, exc=None) -> dict:
    """The armor seam's account of a case: its counters, the degraded
    labels and wire trips so far, and a typed error's provenance."""
    from dhqr_tpu_torch import armor

    report = {"metrics": state.metrics_snapshot(),
              "degraded": armor.degraded_labels(),
              "trips": armor.export_wire_trips()}
    if exc is not None:
        report["error"] = {
            name: getattr(exc, name, None) for name in (
                "label", "shard_index", "recovery", "engine")}
        attempts = getattr(exc, "attempts", None) or ()
        report["error"]["attempts"] = [a.outcome for a in attempts]
    return report


def results_equal_across_ranks(results) -> bool:
    """Whether every rank returned the same numpy values (a replicated
    result must be bit-identical on every rank)."""
    def same(a, b):
        if isinstance(a, np.ndarray):
            return isinstance(b, np.ndarray) and a.shape == b.shape \
                and bool(np.array_equal(a, b, equal_nan=True))
        if isinstance(a, (tuple, list)):
            return isinstance(b, (tuple, list)) and len(a) == len(b) \
                and all(same(x, y) for x, y in zip(a, b))
        return a == b

    return all(same(results[0], r) for r in results[1:])
