"""The op log: the port's counterpart of a closed jaxpr.

The JAX package's graph passes walk the program an entry point traces.
The port runs eagerly and traces nothing, so its graph passes read what an
entry point *does* instead: :func:`record` arms a
``TorchDispatchMode`` that logs every op the entry point dispatches (the
ATen ops, and the ``c10d`` collectives with their process group), in issue
order, into an :class:`OpLog`.

The panel kernels are loaded through ``ctypes``, so the dispatcher never
sees them. Their wrapper (``ops/hopper_panel._panel_qr_kernel``) and its
plain leaf record one :class:`OpEvent` of kind ``"kernel"`` per launch
(:func:`kernel`): the kernel's name, which path ran (``"kernel"`` on the
card, ``"plain"`` for the plain PyTorch version), the panel's shape, dtype
and offset. That event is the port's ``pallas_call`` eqn. Disarmed, the
wrapper's cost is one check of the module global :data:`ARMED`.

A log keeps nested :class:`Scope`\\ s, the counterparts of the sub-jaxprs:
the entry point (the root), a mesh engine's shard body (opened by the mesh
engines' instrumentation seam, ``obs/pulse.observed_dispatch``), the
engines' output relayout (``parallel/wire.wire_all_gather(relayout=True)``,
the JAX package's output sharding, done outside its program), and a CUDA
graph's capture body (``serve/cache``). :func:`sub_jaxprs` and
:func:`iter_jaxprs` walk them. Recording reads only the ops' metadata
(names, shapes, dtypes, devices, groups), never a value, so it syncs
nothing and leaves a CUDA graph capture intact; it is never armed in a
timed region.

The mode is per thread (the dispatcher's mode stack is thread-local): ops
that another thread issues are not in the log.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import torch

try:
    from torch.utils._python_dispatch import TorchDispatchMode as _ModeBase
except ImportError:  # a torch without dispatch modes: record() refuses
    _ModeBase = None

#: The innermost armed log, or None: the kernel wrapper's one check.
ARMED: "OpLog | None" = None
_STACK: "list[OpLog]" = []

#: Ops that read a device value back to the host (besides the copies to
#: the CPU, which are recognized by their devices).
SYNC_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "_unique2",
    "unique_dim", "unique_consecutive", "unique_dim_consecutive", "equal",
})
_COPY_OPS = frozenset({"_to_copy", "copy_", "_copy_from"})
#: The double-precision dtypes an f32 program must not promote to.
F64_DTYPES = ("float64", "complex128")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One dispatched op, collective or kernel launch.

    ``kind`` is ``"op"``, ``"collective"`` or ``"kernel"``; ``name`` the
    op's overload (``"aten.mm.default"``, ``"c10d.broadcast_.default"``)
    or the kernel's name. Collectives carry their ``family`` (the c10d
    op, ``"broadcast_"``), ``payload_bytes`` (the bytes of their tensors,
    of the gathered outputs for a gather: the JAX census's output-aval
    convention), the process ``group``'s name and the mesh ``axes`` the
    log registered for it (empty for a group the log does not know).
    Kernel events carry ``path`` and ``offset``. ``sync`` names why the op
    reads a value back to the host; ``where`` is the port's function that
    issued a syncing op or one that promotes to double precision."""

    kind: str
    name: str
    out_dtypes: "tuple[str, ...]" = ()
    out_shapes: "tuple[tuple[int, ...], ...]" = ()
    in_dtypes: "tuple[str, ...]" = ()
    out_bytes: int = 0
    family: str = ""
    payload_bytes: int = 0
    group: "str | None" = None
    axes: "tuple[str, ...]" = ()
    path: str = ""
    offset: int = 0
    sync: str = ""
    where: str = ""

    @property
    def primitive(self) -> str:
        """The op's short name: ``"mm"`` for ``aten.mm.default``."""
        parts = self.name.split(".")
        return parts[1] if len(parts) >= 3 else self.name

    def signature(self) -> tuple:
        """What two runs of one program must repeat (DHQR305 / DHQR503)."""
        return (self.kind, self.name, self.out_shapes, self.out_dtypes,
                self.family, self.axes, self.path, self.offset)


@dataclasses.dataclass
class Scope:
    """One nested program body: ``entries`` holds its events and its child
    scopes in issue order. ``input_bytes`` is the working set a shard body
    was given (0 where it is not known)."""

    name: str
    entries: list = dataclasses.field(default_factory=list)
    input_bytes: int = 0

    @property
    def eqns(self) -> "list[OpEvent]":
        """The events directly in this scope (a jaxpr's ``eqns``)."""
        return [e for e in self.entries if isinstance(e, OpEvent)]

    @property
    def scopes(self) -> "list[Scope]":
        return [e for e in self.entries if isinstance(e, Scope)]

    def events(self) -> "list[OpEvent]":
        """Every event of this scope and its children, in issue order."""
        out = []
        for e in self.entries:
            out.extend(e.events() if isinstance(e, Scope) else [e])
        return out


class OpLog:
    """The record of one entry point: its root :class:`Scope` and the mesh
    axes of the process groups it may use (``groups``: group name ->
    axis names)."""

    def __init__(self, name: str = "entry", groups=None):
        self.root = Scope(name)
        self._open = [self.root]
        self.groups: "dict[str, tuple[str, ...]]" = {}
        for group, axes in dict(groups or {}).items():
            self.register_group(group, axes)

    def register_group(self, group, axes) -> None:
        """Name the mesh axes of ``group`` (a process group, its name, or
        None for the default group)."""
        self.groups[group_name(group)] = tuple(
            (axes,) if isinstance(axes, str) else axes)

    def add(self, event: OpEvent) -> None:
        self._open[-1].entries.append(event)

    def push(self, name: str, input_bytes: int = 0) -> Scope:
        child = Scope(name, input_bytes=int(input_bytes))
        self._open[-1].entries.append(child)
        self._open.append(child)
        return child

    def pop(self) -> None:
        if len(self._open) > 1:
            self._open.pop()

    def events(self) -> "list[OpEvent]":
        return self.root.events()

    def kernel_events(self) -> "list[OpEvent]":
        return [e for e in self.events() if e.kind == "kernel"]

    def collectives(self) -> "list[OpEvent]":
        return [e for e in self.events() if e.kind == "collective"]

    def syncs(self) -> "list[OpEvent]":
        return [e for e in self.events() if e.sync]

    def signature(self) -> tuple:
        return tuple(e.signature() for e in self.events())


def group_name(group) -> str:
    """The name of a process group (None: the default group)."""
    import torch.distributed as dist

    if group is None:
        group = dist.group.WORLD
    return group if isinstance(group, str) else group.group_name


def _flat(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, out)
    return out


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _caller() -> str:
    """The innermost function of the port (outside this module) on the
    Python stack: ``"ops/blocked.py:_blocked_qr_impl"``."""
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_PKG + os.sep) and fn != _SELF:
            rel = os.path.relpath(fn, _PKG).replace(os.sep, "/")
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return "<outside dhqr_tpu_torch>"


def _process_group(args):
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject) \
                and "ProcessGroup" in a._type().name():
            return dist.ProcessGroup.unbox(a)
    return None


def _event(func, args, kwargs, out, log: OpLog) -> OpEvent:
    name = str(func)
    ins = _flat(list(args) + list(kwargs.values()), [])
    outs = _flat(out, [])
    short = name.split(".")[1] if name.count(".") >= 2 else name
    common = dict(out_dtypes=tuple(_dtype(t) for t in outs),
                  out_shapes=tuple(tuple(t.shape) for t in outs),
                  in_dtypes=tuple(_dtype(t) for t in ins),
                  out_bytes=_nbytes(outs))
    if name.startswith("c10d."):
        payload = _flat(args[0], []) if args else []
        pg = _process_group(args)
        gname = pg.group_name if pg is not None else None
        return OpEvent("collective", name, family=short,
                       payload_bytes=_nbytes(payload), group=gname,
                       axes=log.groups.get(gname, ()), **common)
    sync = ""
    promoted = any(d in F64_DTYPES for d in common["out_dtypes"]) and \
        not any(d in F64_DTYPES for d in common["in_dtypes"])
    if short in SYNC_OPS:
        sync = short
    elif short in _COPY_OPS:
        dst = outs if short != "copy_" else outs[:1]
        if any(t.device.type != "cpu" for t in ins[1:] or ins) and \
                any(t.device.type == "cpu" for t in dst):
            sync = "to_cpu"
    return OpEvent("op", name, sync=sync,
                   where=_caller() if sync or promoted else "", **common)


if _ModeBase is not None:
    class _Recorder(_ModeBase):
        """Logs every dispatched op into ``log``, after running it."""

        def __init__(self, log: OpLog):
            super().__init__()
            self.log = log

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.log.add(_event(func, args, kwargs, out, self.log))
            return out


@contextlib.contextmanager
def record(name: str = "entry", groups=None):
    """Arm an op log for the calling thread's ops while the scope is open;
    yields the :class:`OpLog`. Logs nest: an inner log's ops reach the
    outer ones too. ``groups`` maps process groups to the mesh axes they
    serve (:meth:`OpLog.register_group`)."""
    global ARMED
    if _ModeBase is None:
        raise RuntimeError(
            "this torch has no TorchDispatchMode: the op log cannot be "
            "recorded")
    log = OpLog(name, groups)
    _STACK.append(log)
    ARMED = log
    try:
        with _Recorder(log):
            yield log
    finally:
        _STACK.remove(log)
        ARMED = _STACK[-1] if _STACK else None


@contextlib.contextmanager
def scope(name: str, input_bytes: int = 0):
    """Open a nested scope in every armed log (nothing when disarmed)."""
    logs = list(_STACK)
    for log in logs:
        log.push(name, input_bytes)
    try:
        yield
    finally:
        for log in logs:
            log.pop()


def scoped(name: str, thunk, input_bytes: int = 0):
    """``thunk`` run inside :func:`scope` ``(name)``."""
    def run():
        with scope(name, input_bytes):
            return thunk()
    return run


def kernel(name: str, path: str, shape, dtype, offset: int) -> None:
    """Record one launch of the panel kernel ``name`` (or of its plain
    version, ``path="plain"``) in every armed log."""
    event = OpEvent("kernel", name, out_dtypes=(str(dtype).replace(
        "torch.", ""),), out_shapes=(tuple(int(d) for d in shape),),
        path=path, offset=int(offset))
    for log in _STACK:
        log.add(event)


def sub_jaxprs(val):
    """Yield every scope held by a value: a :class:`Scope`, an
    :class:`OpLog`'s root, or any list/tuple/dict nesting of them (the
    twin of ``jaxpr_pass.sub_jaxprs``)."""
    if isinstance(val, OpLog):
        yield val.root
    elif isinstance(val, Scope):
        yield val
    elif isinstance(val, (list, tuple)):
        for v in val:
            yield from sub_jaxprs(v)
    elif isinstance(val, dict):
        for v in val.values():
            yield from sub_jaxprs(v)


def iter_jaxprs(log):
    """Yield ``log``'s root scope (or ``log`` itself, a scope) and every
    scope nested in it, parents first."""
    stack = list(sub_jaxprs(log))[::-1]
    while stack:
        s = stack.pop()
        yield s
        stack.extend(reversed(s.scopes))
