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
    if isinstance(value, dict):
        return {k: _numpy(v) for k, v in value.items()}
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

    from dhqr_tpu_torch import armor, faults
    from dhqr_tpu_torch.parallel import wire

    mesh_of = _mesh_getter(device)
    out = []
    for case in cases:
        if not isinstance(case, dict):
            case = {"steps": case}
        scope = faults.injected(case["faults"]) if case.get("faults") \
            else contextlib.nullcontext()
        armed = armor.armored(case["armor"]) if case.get("armor") \
            else contextlib.nullcontext()
        try:
            with armed as state, scope, wire.census() as seen:
                try:
                    value = _run_steps(case["steps"], mesh_of, device)
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


def _mesh_getter(device):
    """``mesh_of(name)``: this rank's column mesh ("cols"), row mesh
    ("rows") or pod mesh ("pod:<topo>", made at its first use)."""
    from dhqr_tpu_torch import parallel

    meshes = {"cols": parallel.column_mesh(device=device),
              "rows": parallel.row_mesh(device=device)}

    def mesh_of(name):
        if name not in meshes:  # "pod:<topo>"
            meshes[name] = parallel.pod_mesh(topo=name[4:],
                                             device=device)[0]
        return meshes[name]

    return mesh_of


def _run_steps(steps, mesh_of, device, inputs=()):
    """The value of a :func:`run_calls` case's steps; :class:`Arg`
    placeholders take ``inputs``."""
    import importlib

    import dhqr_tpu_torch
    from dhqr_tpu_torch import parallel

    value = None

    def bind(x):
        if isinstance(x, Arg):
            return inputs[x.index]
        if isinstance(x, Placeholder):  # compared by name: it was pickled
            return value if x.name == PREV.name else mesh_of(x.name)
        if isinstance(x, AsTensor):
            return torch.as_tensor(x.array, device=device)
        if isinstance(x, (tuple, list)):
            return type(x)(bind(v) for v in x)
        if isinstance(x, dict):
            return {k: bind(v) for k, v in x.items()}
        return x

    for target, args, kwargs in steps:
        args, kwargs = bind(args), bind(kwargs)
        if target.startswith("."):
            value = getattr(value, target[1:])(*args, **kwargs)
            continue
        path, _, name = target.rpartition(".")
        mod = importlib.import_module(f"dhqr_tpu_torch.{path}") if path \
            else parallel if hasattr(parallel, name) else dhqr_tpu_torch
        value = getattr(mod, name)(*args, **kwargs)
    return value


class Arg:
    """The ``index``-th input of a :func:`run_grads` case, in its steps."""

    def __init__(self, index: int):
        self.index = index


def _picked(value, spec):
    """An output of a case's value: the value itself (None), an item of a
    tuple (an int) or an attribute (a name)."""
    if spec is None:
        return value
    return value[spec] if isinstance(spec, int) else getattr(value, spec)


def _weight(w, value, device):
    """A loss weight as a tensor: an array, or ``("store", W)``, the
    natural-order W (the caller's m x n) as this rank's store-order block
    of the mesh factorization ``value`` (zeros on its padded rows and
    columns)."""
    from dhqr_tpu_torch.parallel import sharded_qr

    if not isinstance(w, tuple):
        return torch.as_tensor(w, device=device)
    W = torch.as_tensor(w[1], device=device)
    m_pad, nloc = value.H.shape
    n_pad = nloc * value.mesh.size
    Wp = W.new_zeros((m_pad, n_pad))
    Wp[:W.shape[0], :W.shape[1]] = W
    return sharded_qr._local_block(Wp, value.mesh, n_pad, value.block_size,
                                   value.layout)


def _inner(ws, xs) -> torch.Tensor:
    """``sum Re <w, x>`` over the pairs (PyTorch's complex convention)."""
    return sum(torch.sum(torch.real(w.conj() * x)) for w, x in zip(ws, xs))


# The blocked engine's names of the panel kernel's two entries: the
# wrapper, and the leaf that factors in place in H.
_KERNEL_ENTRIES = ("_panel_qr_kernel", "_panel_qr_kernel_in_place")


def run_grads(device, cases):
    """Worker: differentiate each case on this rank; per case ``("ok",
    result)`` with tensors as numpy arrays, or ``("raised", exception type
    name, message)``.

    A case is a dict: ``"inputs"`` (numpy arrays; :class:`Arg` ``(i)`` in
    the steps stands for the i-th), ``"wrt"`` (the indices autograd
    follows), ``"steps"`` (as :func:`run_calls`'s), ``"out"`` (the outputs
    of the steps' value, :func:`_picked` specs; default: the value),
    ``"weights"`` (one per output, :func:`_weight` specs) and optionally
    ``"tangents"`` (one per ``wrt`` input) with ``"mode"`` ``"dual"``
    (forward-AD dual tensors, the default) or ``"func"``
    (``torch.func.jvp``). This rank's loss is ``sum Re <w, out>`` over the
    outputs. The result: ``"plain"`` (the outputs with grad off),
    ``"outs"`` (with grad on), ``"calls"`` (the panel-kernel wrapper's
    calls in each of the two), ``"losses"`` (``Re <w, out>`` per output),
    ``"grads"``, and with tangents ``"jvp"`` (the outputs' tangents),
    ``"wJu"`` (``Re <w, J u>`` per output) and ``"gu"`` (``sum Re <grad,
    u>``); ``"census"`` holds the wire census's entries of the backward
    and of the jvp."""
    import torch.autograd.forward_ad as fwAD

    from dhqr_tpu_torch.ops import blocked
    from dhqr_tpu_torch.parallel import wire

    mesh_of = _mesh_getter(device)
    real = {name: getattr(blocked, name) for name in _KERNEL_ENTRIES}
    calls = []

    def counting(fn):
        def count(*args, **kwargs):
            calls.append(1)
            return fn(*args, **kwargs)
        return count

    def outputs(case, args):
        value = _run_steps(case["steps"], mesh_of, device, args)
        return value, [_picked(value, o) for o in case.get("out", [None])]

    out = []
    for name, fn in real.items():
        setattr(blocked, name, counting(fn))
    try:
        for case in cases:
            try:
                inputs = [torch.as_tensor(a, device=device)
                          for a in case["inputs"]]
                wrt = list(case.get("wrt", range(len(inputs))))
                calls.clear()
                with torch.no_grad():
                    plain = outputs(case, inputs)[1]
                n_plain = len(calls)
                leaves = [t.clone().requires_grad_(i in wrt)
                          for i, t in enumerate(inputs)]
                value, outs = outputs(case, leaves)
                n_grad = len(calls) - n_plain
                ws = [_weight(w, value, device) for w in case["weights"]]
                losses = [_inner([w], [o]) for w, o in zip(ws, outs)]
                with wire.census(every_thread=True) as seen:
                    sum(losses).backward()
                grads = [leaves[i].grad for i in wrt]
                result = {"plain": plain, "outs": [o.detach() for o in outs],
                          "calls": (n_plain, n_grad),
                          "losses": [x.item() for x in losses],
                          "grads": grads, "census": {"vjp": seen.entries}}
                if case.get("tangents") is not None:
                    us = [torch.as_tensor(u, device=device)
                          for u in case["tangents"]]
                    with wire.census() as seen:
                        jvp = _tangents(case, inputs, wrt, us, outputs,
                                        fwAD)
                    result.update(
                        jvp=jvp, gu=_inner(grads, us).item(),
                        wJu=[_inner([w], [t]).item()
                             for w, t in zip(ws, jvp)])
                    result["census"]["jvp"] = seen.entries
                out.append(("ok", _numpy(result)))
            except Exception as exc:  # the case's outcome, for the caller
                out.append(("raised", type(exc).__name__, str(exc)))
    finally:
        for name, fn in real.items():
            setattr(blocked, name, fn)
    return out


def _tangents(case, inputs, wrt, us, outputs, fwAD):
    """The outputs' tangents along ``us`` (one per ``wrt`` input)."""
    if case.get("mode", "dual") == "func":
        def f(*xs):
            args = list(inputs)
            for i, x in zip(wrt, xs):
                args[i] = x
            return tuple(outputs(case, args)[1])

        return list(torch.func.jvp(f, tuple(inputs[i] for i in wrt),
                                   tuple(us))[1])
    with fwAD.dual_level():
        args = list(inputs)
        for i, u in zip(wrt, us):
            args[i] = fwAD.make_dual(inputs[i], u)
        return [fwAD.unpack_dual(o).tangent
                for o in outputs(case, args)[1]]


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
