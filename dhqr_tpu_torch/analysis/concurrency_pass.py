"""dhqr-warden — lock-discipline & deadlock-order analysis (DHQR6xx) over
the port: the twin of ``dhqr_tpu/analysis/concurrency_pass.py``.

The port's serving tier is multi-threaded as the JAX package's is
(scheduler worker pools, the compile/quarantine cache path, the replica
router, the obs recorder ring, the metrics registry), and it adds locks
of its own: each :class:`~dhqr_tpu_torch.serve.cache.DeviceLane` holds
one (``serve.cache.DeviceLane.lock``: its programs warm up, are captured
and replay under it) and the lane table another (``cache._LANES_LOCK``).
The four rules carry over:

* **DHQR601 — guarded-field discipline.** A *thread-shared class* (one
  that constructs a lock in ``__init__``) declares every mutable
  container attribute with a ``# guarded by: <lock-attr>`` comment on
  its ``__init__`` assignment (or ``# guarded by: frozen``). Any read or
  write of a lock-guarded attribute outside a ``with self.<lock>`` block
  convicts; private helpers inherit the locks held at EVERY one of their
  intra-class call sites (an entry-held fixpoint).
* **DHQR602 — lock-order.** Every nested acquisition is extracted
  statically (lexical nesting plus one call level deep through
  self-method / same-module-function resolution) into the package-wide
  acquisition-order digraph. The committed edge list
  (``analysis/lock_order.json``, the port's own) must match the
  extracted static edges BOTH ways, and the committed union (static +
  runtime-witnessed sources) must be acyclic. The runtime witness gate
  reports under the same rule id.
* **DHQR603 — blocking-while-locked.** ``Future.result()``, ``sleep``,
  ``flock``, the ``subprocess`` family, the compile/dispatch entry
  points (``.compile()``, ``checked_dispatch``), and the card's blocking
  calls: ``.synchronize()`` / ``torch.cuda.synchronize``, a CUDA-graph
  capture (``torch.cuda.graph``, ``capture_begin``) or ``replay``, and
  ``ops._build.load`` (an nvcc build), invoked with a lock held.
* **DHQR604 — unsynchronized publication.** A post-``__init__``
  assignment creating a NEW attribute on a thread-shared class outside
  any lock.

Two resolutions beyond the JAX pass's, both for the lanes: a ``with
lane.lock`` on another object resolves to the lock of the one class of
the file that owns a lock attribute of that name, and a ``with
x.entered()`` on a ``@contextmanager`` method of a class of the file
resolves to the lock that method takes.

The static graph is validated by execution: with
:mod:`dhqr_tpu_torch.utils.lockwitness` armed, a seeded multi-threaded
workload (two schedulers behind a router sharing a cache, tracing armed,
a fault site that never fires) runs on a device and the gate asserts
every witnessed edge is present in the committed graph, the witnessed
graph is acyclic, and no held-set violation occurred. On the card the
workload also captures and replays its bucket programs under the lane
locks, which the CPU never does.

Scope of the self-scan: ``serve/``, ``obs/``, ``faults/``, ``armor/``,
``tune/db.py``, ``utils/lockwitness.py``. Ships with an EMPTY baseline:
every finding is a real fix or a reasoned inline suppression.
"""

from __future__ import annotations

import ast
import json
import os
import re

from dhqr_tpu_torch.analysis.findings import (
    Finding,
    apply_suppressions,
    parse_suppressions,
)

RULES = (
    ("DHQR601",
     "guarded-field discipline: '# guarded by:' declared and honored",
     "conc"),
    ("DHQR602",
     "lock-order: nested acquisitions committed, union graph acyclic",
     "conc"),
    ("DHQR603",
     "blocking call (result/sleep/flock/subprocess/compile/synchronize/"
     "capture/replay/nvcc) under a lock",
     "conc"),
    ("DHQR604",
     "unsynchronized publication: new attribute created outside any lock",
     "conc"),
)

#: The committed acquisition-order digraph (new edges are deliberate,
#: reviewed commits).
EDGES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "lock_order.json")
EDGES_SCHEMA = "dhqr-lock-order"
EDGES_VERSION = 1

#: The self-scan scope: the package's thread-shared tier.
SCOPE_DIRS = ("serve", "obs", "faults", "armor")
SCOPE_FILES = (os.path.join("tune", "db.py"),
               os.path.join("utils", "lockwitness.py"))

#: The lock every serve program warms up, is captured and replays under.
LANE_LOCK = "serve.cache.DeviceLane.lock"

_GUARDED_RE = re.compile(r"#\s*guarded by:\s*([A-Za-z_]\w*)")

#: Lock-constructor spellings (raw primitives and the lockwitness seam).
_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock"}
_SEAM_CTORS = ("make_lock", "make_rlock")
_CONDITION_CTORS = {"threading.Condition", "Condition"}

#: Container constructors whose attributes are forced-annotation
#: candidates in a thread-shared class.
_CONTAINER_CTORS = {"dict", "list", "set", "deque", "OrderedDict",
                    "defaultdict", "Counter"}

#: Blocking-call matchers for DHQR603. ``.compile`` excludes the
#: ``re``/``ast`` modules (pattern compilation is not a program build).
_SLEEP_NAMES = {"sleep", "_sleep", "_sleeper", "sleeper"}
_SUBPROCESS_NAMES = {"Popen", "check_call", "check_output", "call"}
_COMPILE_EXEMPT_VALUES = {"re", "ast", "sre_compile"}
#: The card's blocking calls: a host wait on the device, a CUDA-graph
#: capture or replay, and the kernels' nvcc build.
_SYNC_ATTRS = {"synchronize"}
_CAPTURE_ATTRS = {"capture_begin", "capture_end", "replay"}


def _dotted(node) -> str:
    """Best-effort dotted spelling of a Name/Attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_self_attr(node) -> "str | None":
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _snippet(lines, lineno) -> str:
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


def _guard_comment(lines, lineno) -> "str | None":
    """The ``# guarded by: X`` annotation for the assignment at
    ``lineno`` — on the line itself or the line directly above."""
    for ln in (lineno, lineno - 1):
        if not 1 <= ln <= len(lines):
            continue
        line = lines[ln - 1]
        if ln != lineno and not line.lstrip().startswith("#"):
            continue  # line-above form must be a comment-only line
        m = _GUARDED_RE.search(line)
        if m:
            return m.group(1)
    return None


def _is_lock_ctor(value) -> "str | None":
    """'lock' / 'condition' / None for an ``__init__`` assignment
    value. The lockwitness seam (make_lock/make_rlock) counts; its
    string argument, when literal, becomes the node name."""
    if not isinstance(value, ast.Call):
        return None
    dotted = _dotted(value.func)
    leaf = dotted.rsplit(".", 1)[-1]
    if dotted in _LOCK_CTORS or leaf in _SEAM_CTORS:
        return "lock"
    if dotted in _CONDITION_CTORS:
        return "condition"
    return None


def _seam_name(value) -> "str | None":
    """The literal name passed to make_lock/make_rlock, if any."""
    if isinstance(value, ast.Call) and value.args and \
            isinstance(value.args[0], ast.Constant) and \
            isinstance(value.args[0].value, str):
        return value.args[0].value
    return None


def _is_container_init(value) -> bool:
    if isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                          ast.SetComp, ast.DictComp)):
        return True
    if isinstance(value, ast.BinOp):
        # [False] * k and friends
        return _is_container_init(value.left) or \
            _is_container_init(value.right)
    if isinstance(value, ast.Call):
        leaf = _dotted(value.func).rsplit(".", 1)[-1]
        return leaf in _CONTAINER_CTORS
    return False


class _ClassInfo:
    """Everything DHQR601/604 need to know about one class."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.lock_attrs: "dict[str, str]" = {}   # attr -> node name
        self.cond_alias: "dict[str, str]" = {}   # condition attr -> lock attr
        self.guarded: "dict[str, str]" = {}      # attr -> lock attr | frozen
        self.init_assigned: "set[str]" = set()
        self.candidates: "dict[str, int]" = {}   # unannotated attr -> line
        self.methods: "dict[str, ast.FunctionDef]" = {}
        self.context_managers: "set[str]" = set()  # @contextmanager methods

    @property
    def thread_shared(self) -> bool:
        return bool(self.lock_attrs)

    def lock_node(self, attr: str) -> "str | None":
        """The graph node a ``with self.<attr>`` acquisition maps to,
        through the Condition alias (``Condition(self._lock)`` shares
        its underlying lock's node)."""
        attr = self.cond_alias.get(attr, attr)
        return self.lock_attrs.get(attr)


def _harvest_class(cls: ast.ClassDef, lines) -> _ClassInfo:
    info = _ClassInfo(cls.name)
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.methods[stmt.name] = stmt
            if any(_dotted(d).rsplit(".", 1)[-1] == "contextmanager"
                   for d in stmt.decorator_list):
                info.context_managers.add(stmt.name)
    init = info.methods.get("__init__")
    if init is None:
        return info
    for node in ast.walk(init):
        targets = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        for target in targets:
            attr = _is_self_attr(target)
            if attr is None:
                continue
            info.init_assigned.add(attr)
            if value is None:
                continue
            kind = _is_lock_ctor(value)
            if kind == "lock":
                info.lock_attrs[attr] = \
                    _seam_name(value) or f"{info.name}.{attr}"
            elif kind == "condition":
                arg = value.args[0] if value.args else None
                aliased = _is_self_attr(arg) if arg is not None else None
                if aliased is not None:
                    info.cond_alias[attr] = aliased
                else:
                    info.lock_attrs[attr] = f"{info.name}.{attr}"
            guard = _guard_comment(lines, node.lineno)
            if guard is not None:
                info.guarded[attr] = guard
            elif _is_container_init(value) and kind is None:
                info.candidates.setdefault(attr, node.lineno)
    return info


def _harvest_module_locks(tree: ast.Module, modbase: str) -> "dict[str, str]":
    """Module-global lock names -> graph node names."""
    locks = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            if _is_lock_ctor(stmt.value) in ("lock", "condition"):
                name = stmt.targets[0].id
                locks[name] = _seam_name(stmt.value) or \
                    f"{modbase}.{name}"
    return locks


class _FileScan:
    """One file's scan state: findings, extracted edges, call sites."""

    def __init__(self, path: str, text: str) -> None:
        self.path = path
        self.lines = text.splitlines()
        self.tree = ast.parse(text)
        self.modbase = os.path.splitext(os.path.basename(path))[0]
        if self.modbase == "__init__":      # armor/__init__.py -> "armor"
            self.modbase = os.path.basename(os.path.dirname(path))
        self.module_locks = _harvest_module_locks(self.tree, self.modbase)
        self.classes = {
            c.name: _harvest_class(c, self.lines)
            for c in self.tree.body if isinstance(c, ast.ClassDef)
        }
        self.findings: "list[Finding]" = []
        # (from, to) -> "path:line" of the acquiring site
        self.edges: "dict[tuple[str, str], str]" = {}
        # Deferred DHQR601 convictions: (cls, method, needed lock node,
        # line, message) — filtered by the entry-held fixpoint.
        self._deferred: list = []
        # (cls, callee) -> list of (caller_method, frozenset(held))
        self._call_sites: "dict[tuple[str, str], list]" = {}
        # Per-function direct acquisitions, for one-call-level edges:
        # key ("C", "m") or (None, "f") -> {(node, line), ...}
        self._fn_acquires: "dict[tuple, set]" = {}

    # ---------------------------------------------------------- resolution

    def _resolve_acquisition(self, expr, cls: "_ClassInfo | None"
                             ) -> "str | None":
        """The graph node a with-item acquires, or None."""
        attr = _is_self_attr(expr)
        if attr is not None and cls is not None:
            return cls.lock_node(attr)
        if isinstance(expr, ast.Name):
            return self.module_locks.get(expr.id)
        if isinstance(expr, ast.Attribute):
            # ``lane.lock``: the lock attribute of the one class of this
            # file that owns a lock under that name.
            owners = {info.lock_node(expr.attr)
                      for info in self.classes.values()
                      if info.lock_node(expr.attr) is not None}
            return owners.pop() if len(owners) == 1 else None
        if isinstance(expr, ast.Call):
            func = expr.func
            if isinstance(func, ast.Attribute) and \
                    func.attr == "_file_lock":
                owner = _is_self_attr(func)
                if owner is not None and cls is not None:
                    return f"{cls.name}._file_lock"
                if isinstance(func.value, ast.Name):
                    return f"{func.value.id}._file_lock"
            if isinstance(func, ast.Attribute):
                # ``x.entered()``: a @contextmanager method of a class of
                # this file that takes exactly one lock.
                takes = {node for info in self.classes.values()
                         if func.attr in info.context_managers
                         for node, _ in self._fn_acquires.get(
                             (info.name, func.attr), ())}
                return takes.pop() if len(takes) == 1 else None
        return None

    # ------------------------------------------------------------- findings

    def _f(self, rule, line, message):
        self.findings.append(Finding(
            rule, self.path, line, message,
            snippet=_snippet(self.lines, line)))

    # ------------------------------------------------------------- walking

    def scan(self) -> None:
        for info in self.classes.values():
            if not info.thread_shared:
                continue
            for attr, line in sorted(info.candidates.items(),
                                     key=lambda kv: kv[1]):
                # Annotated on ANOTHER __init__ assignment (e.g. the
                # empty default before a conditional re-assignment).
                if attr in info.guarded:
                    continue
                self._f("DHQR601", line,
                        f"mutable attribute 'self.{attr}' of "
                        f"thread-shared class {info.name} has no "
                        "'# guarded by: <lock-attr>' (or 'frozen') "
                        "annotation")
        # Pre-pass: every function's direct acquisitions (for the
        # one-call-level DHQR602 resolution).
        # Context managers first: a ``with x.entered()`` elsewhere
        # resolves through their acquisitions.
        for cls_name, fn in sorted(
                self._iter_functions(),
                key=lambda cf: not (cf[0] and cf[1].name in
                                    self.classes[cf[0]].context_managers)):
            cls = self.classes.get(cls_name) if cls_name else None
            acquires = set()
            for node in ast.walk(fn):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        resolved = self._resolve_acquisition(
                            item.context_expr, cls)
                        if resolved:
                            acquires.add((resolved, item.context_expr
                                          .lineno))
            self._fn_acquires[(cls_name, fn.name)] = acquires
        # Main walk.
        for cls_name, fn in self._iter_functions():
            cls = self.classes.get(cls_name) if cls_name else None
            held = frozenset()
            for stmt in fn.body:
                self._walk_stmt(stmt, held, cls, fn.name)
        self._resolve_entry_held()

    def _iter_functions(self):
        for stmt in self.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield None, stmt
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        yield stmt.name, sub

    def _walk_stmt(self, stmt, held, cls, method) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in stmt.items:
                self._check_expr(item.context_expr, held, cls, method)
                node = self._resolve_acquisition(item.context_expr, cls)
                if node is not None:
                    site = f"{self.path}:{item.context_expr.lineno}"
                    for held_node in held:
                        self.edges.setdefault((held_node, node), site)
                    acquired.append(node)
            new_held = held | frozenset(acquired)
            for sub in stmt.body:
                self._walk_stmt(sub, new_held, cls, method)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def runs later, on whatever thread calls it —
            # conservatively an unlocked scope (its own with-blocks
            # still track).
            for sub in stmt.body:
                self._walk_stmt(sub, frozenset(), cls, method)
            return
        for field, value in ast.iter_fields(stmt):
            if isinstance(value, list):
                for child in value:
                    if isinstance(child, ast.stmt):
                        self._walk_stmt(child, held, cls, method)
                    elif isinstance(child, ast.excepthandler):
                        for sub in child.body:
                            self._walk_stmt(sub, held, cls, method)
                    elif isinstance(child, ast.expr):
                        self._check_expr(child, held, cls, method)
            elif isinstance(value, ast.expr):
                self._check_expr(value, held, cls, method)

    def _check_expr(self, expr, held, cls, method) -> None:
        lambdas = []
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Lambda):
                lambdas.append(node.body)
                continue
            stack.extend(ast.iter_child_nodes(node))
            if isinstance(node, ast.Attribute):
                self._check_attribute(node, held, cls, method)
            elif isinstance(node, ast.Call):
                self._check_call(node, held, cls, method)
        for body in lambdas:
            self._check_expr(body, frozenset(), cls, method)

    def _check_attribute(self, node, held, cls, method) -> None:
        if cls is None or not cls.thread_shared or method == "__init__":
            return
        attr = _is_self_attr(node)
        if attr is None:
            return
        is_write = isinstance(node.ctx, (ast.Store, ast.Del))
        guard = cls.guarded.get(attr)
        if guard == "frozen":
            if is_write:
                self._f("DHQR601", node.lineno,
                        f"write to frozen attribute 'self.{attr}' of "
                        f"{cls.name} outside __init__ (declared "
                        "'# guarded by: frozen')")
            return
        if guard is not None:
            needed = cls.lock_node(guard) or f"{cls.name}.{guard}"
            if needed not in held:
                access = "write to" if is_write else "read of"
                self._deferred.append((
                    cls.name, method, needed, node.lineno,
                    f"{access} 'self.{attr}' (guarded by "
                    f"'{guard}') outside 'with self.{guard}' in "
                    f"{cls.name}.{method}"))
            return
        if is_write and attr not in cls.init_assigned and not held:
            self._f("DHQR604", node.lineno,
                    f"post-__init__ publication of new attribute "
                    f"'self.{attr}' on thread-shared class "
                    f"{cls.name} outside any lock")

    def _check_call(self, node, held, cls, method) -> None:
        # Intra-class call sites (entry-held fixpoint input) and
        # one-call-level DHQR602 edges.
        callee_key = None
        attr = _is_self_attr(node.func)
        if attr is not None and cls is not None and \
                attr in cls.methods:
            callee_key = (cls.name, attr)
            self._call_sites.setdefault(callee_key, []).append(
                (method, held))
        elif isinstance(node.func, ast.Name):
            key = (None, node.func.id)
            if key in self._fn_acquires:
                callee_key = key
        if held and callee_key is not None:
            for acquired, line in self._fn_acquires.get(callee_key, ()):
                site = f"{self.path}:{node.lineno}"
                for held_node in held:
                    if held_node != acquired:
                        self.edges.setdefault((held_node, acquired),
                                              site)
        if held:
            self._check_blocking(node, held)

    def _check_blocking(self, node, held) -> None:
        func = node.func
        dotted = _dotted(func)
        leaf = dotted.rsplit(".", 1)[-1] if dotted else ""
        blocked = None
        if isinstance(func, ast.Attribute) and func.attr == "result":
            blocked = "Future.result()"
        elif leaf in _SLEEP_NAMES or (isinstance(func, ast.Attribute)
                                      and func.attr in _SLEEP_NAMES):
            blocked = "sleep"
        elif leaf == "flock" or (isinstance(func, ast.Attribute)
                                 and func.attr == "flock"):
            blocked = "flock"
        elif dotted.startswith("subprocess.") or \
                leaf in _SUBPROCESS_NAMES:
            blocked = "subprocess"
        elif isinstance(func, ast.Attribute) and func.attr == "compile":
            value_root = _dotted(func.value).split(".", 1)[0]
            if value_root not in _COMPILE_EXEMPT_VALUES:
                blocked = "compile()"
        elif leaf == "checked_dispatch":
            blocked = "checked_dispatch"
        elif isinstance(func, ast.Attribute) and func.attr in _SYNC_ATTRS:
            blocked = "synchronize"
        elif dotted.endswith("cuda.graph") or (
                isinstance(func, ast.Attribute)
                and func.attr in _CAPTURE_ATTRS):
            blocked = "CUDA-graph capture/replay"
        elif dotted.endswith("_build.load"):
            blocked = "nvcc build (_build.load)"
        if blocked is not None:
            self._f("DHQR603", node.lineno,
                    f"blocking call ({blocked}) while holding "
                    f"{', '.join(sorted(held))}")

    # ------------------------------------------------------ entry-held

    def _resolve_entry_held(self) -> None:
        """Fixpoint over private methods: a ``_helper`` inherits the
        intersection of the lock sets held at every intra-class call
        site (callers' own entry-held included), so the ``*_locked``
        convention needs no annotation. Deferred DHQR601 convictions
        whose needed lock is entry-held are dropped."""
        entry: "dict[tuple[str, str], frozenset]" = {}
        for info in self.classes.values():
            universe = frozenset(info.lock_attrs.values())
            for name in info.methods:
                if name.startswith("_") and not name.startswith("__"):
                    sites = self._call_sites.get((info.name, name))
                    entry[(info.name, name)] = \
                        universe if sites else frozenset()
        for _ in range(len(entry) + 1):
            changed = False
            for (cls_name, name), current in entry.items():
                sites = self._call_sites.get((cls_name, name), ())
                if not sites:
                    continue
                new = None
                for caller, held in sites:
                    # Locks held at the call site lexically, plus
                    # whatever the CALLER itself is entry-held under —
                    # so helper-calls-helper chains resolve (e.g. a
                    # `_locked` helper calling a second one).
                    site_held = frozenset(held) | entry.get(
                        (cls_name, caller), frozenset())
                    new = site_held if new is None else (new & site_held)
                new = new or frozenset()
                if new != current:
                    entry[(cls_name, name)] = new
                    changed = True
            if not changed:
                break
        for cls_name, method, needed, line, message in self._deferred:
            if needed in entry.get((cls_name, method), frozenset()):
                continue
            self._f("DHQR601", line, message)


def _scan_text(text: str, path: str):
    """(findings, edges) for one file's source. Findings come back
    suppression-applied (``# dhqr: ignore[DHQR60x] reason``)."""
    scan = _FileScan(path, text)
    scan.scan()
    scan.findings.sort(key=lambda f: (f.line, f.rule))
    suppressions = parse_suppressions(scan.lines)
    return apply_suppressions(scan.findings, suppressions), scan.edges


def scan_concurrency_source(text: str, path: str) -> "list[Finding]":
    """Static DHQR6xx findings for one source text (fixture tests; the
    package-level graph comparison and witness gate live in
    :func:`run_concurrency_pass`)."""
    findings, _edges = _scan_text(text, path)
    return findings


# ---------------------------------------------------------------------------
# Package-level graph: extraction, committed comparison, cycles.

def _scope_files(pkg_root: str) -> "list[str]":
    out = []
    for sub in SCOPE_DIRS:
        base = os.path.join(pkg_root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    out.append(os.path.join(dirpath, name))
    for rel in SCOPE_FILES:
        path = os.path.join(pkg_root, rel)
        if os.path.exists(path):
            out.append(path)
    return sorted(out)


def load_edges(path: "str | None" = None) -> "list[dict]":
    """The committed lock-order edge list (raises on a malformed file —
    the graph is a contract, not telemetry)."""
    path = path or EDGES_PATH
    with open(path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    if raw.get("schema") != EDGES_SCHEMA or \
            raw.get("version") != EDGES_VERSION:
        raise ValueError(f"{path}: not a {EDGES_SCHEMA} v{EDGES_VERSION} "
                         "file")
    edges = raw.get("edges")
    if not isinstance(edges, list):
        raise ValueError(f"{path}: 'edges' must be a list")
    for edge in edges:
        if not isinstance(edge, dict) or not edge.get("from") or \
                not edge.get("to") or edge.get("source") not in (
                    "static", "runtime"):
            raise ValueError(f"{path}: malformed edge {edge!r}")
    return edges


def find_cycle(edges) -> "list[str] | None":
    """One cycle (as a node path) in the digraph, or None. Iterative
    DFS with colors; deterministic over sorted adjacency."""
    adj: "dict[str, list[str]]" = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    for k in adj:
        adj[k].sort()
    color: "dict[str, int]" = {}
    parent: "dict[str, str]" = {}
    for root in sorted(adj):
        if color.get(root):
            continue
        stack = [(root, iter(adj[root]))]
        color[root] = 1
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                state = color.get(nxt, 0)
                if state == 0:
                    color[nxt] = 1
                    parent[nxt] = node
                    stack.append((nxt, iter(adj[nxt])))
                    advanced = True
                    break
                if state == 1:
                    path = [nxt, node]
                    cur = node
                    while cur != nxt and cur in parent:
                        cur = parent[cur]
                        path.append(cur)
                    path.reverse()
                    return path
            if not advanced:
                color[node] = 2
                stack.pop()
        continue
    return None


def _graph_findings(extracted: "dict[tuple, str]", committed,
                    edges_rel: str) -> "list[Finding]":
    findings = []
    committed_static = {(e["from"], e["to"]) for e in committed
                        if e["source"] == "static"}
    committed_all = {(e["from"], e["to"]) for e in committed}
    for (a, b), site in sorted(extracted.items()):
        if (a, b) not in committed_static:
            path, _, line = site.rpartition(":")
            findings.append(Finding(
                "DHQR602", path, int(line),
                f"uncommitted lock-order edge {a} -> {b}: add it to "
                f"analysis/lock_order.json deliberately (source "
                f"\"static\") or restructure the nesting",
                snippet=f"{a} -> {b}"))
    for (a, b) in sorted(committed_static - set(extracted)):
        findings.append(Finding(
            "DHQR602", edges_rel, 0,
            f"stale committed static edge {a} -> {b}: no longer "
            "extracted from the source — remove it",
            snippet=f"{a} -> {b}"))
    cycle = find_cycle(committed_all | set(extracted))
    if cycle is not None:
        findings.append(Finding(
            "DHQR602", edges_rel, 0,
            "lock-order cycle (deadlock hazard): "
            + " -> ".join(cycle),
            snippet=" -> ".join(cycle)))
    return findings


# ---------------------------------------------------------------------------
# Runtime witness gate.

def _witness_workload(requests: int = 8, seed: int = 0,
                      m: int = 48, n: int = 16,
                      submit_threads: int = 2,
                      arm_faults: bool = False,
                      kill_replica: bool = False,
                      device=None, stats: "dict | None" = None):
    """One seeded multi-threaded serving burst under an armed lock
    witness: two real schedulers behind a Router sharing one
    ExecutableCache on ``device`` (None: the card), tracing armed (the
    recorder lock is exercised under the scheduler lock), concurrent
    submitters, drain, shutdown. Returns the witness. ``arm_faults``
    configures a never-firing fault site so the harness lock is visited
    on the compile path; ``kill_replica`` exercises the mid-flight
    failover relay. On the card the cache captures each bucket program
    into a CUDA graph under its lane's lock and replays it there.
    ``stats``, when given, receives the burst's ``requests``, the
    cache's ``captures`` (its misses) and its ``programs`` by mode."""
    import threading

    import numpy as np

    from dhqr_tpu_torch.faults import harness as _faults
    from dhqr_tpu_torch.obs import trace as _trace
    from dhqr_tpu_torch.serve.cache import ExecutableCache
    from dhqr_tpu_torch.serve.router import Router
    from dhqr_tpu_torch.serve.scheduler import AsyncScheduler
    from dhqr_tpu_torch.utils import lockwitness
    from dhqr_tpu_torch.utils.config import (
        FaultConfig,
        FleetConfig,
        ObsConfig,
        ServeConfig,
    )
    from dhqr_tpu_torch.utils.device import as_tensor, resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    A = as_tensor(rng.standard_normal((m, n)).astype(np.float32), dev)
    b = as_tensor(rng.standard_normal((m,)).astype(np.float32), dev)
    scfg = ServeConfig(min_dim=16, ratio=1.5, max_batch=4, cache_size=8)

    def _burst(witness):
        cache = ExecutableCache(max_size=8)
        reps = [AsyncScheduler(serve_config=scfg, cache=cache,
                               block_size=8, workers=1, device=dev)
                for _ in range(2)]
        router = Router(replicas=reps,
                        fleet=FleetConfig(replicas=2, failovers=1))
        futs = []
        errors = []

        def submit_stream(count):
            try:
                for _ in range(count):
                    futs.append(router.submit("lstsq", A, b,
                                              deadline=60.0))
            except Exception as e:  # pragma: no cover - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=submit_stream,
                                    args=(requests // submit_threads,),
                                    name=f"witness-submit-{i}")
                   for i in range(submit_threads)]
        for t in threads:
            t.start()
        if kill_replica:
            router.kill(0)
        for t in threads:
            t.join()
        for rep in reps:
            rep.drain(timeout=60.0)
        results = [f.result(timeout=60.0) for f in list(futs)]
        router.shutdown()
        if errors:
            raise errors[0]
        if stats is not None:
            modes: "dict[str, int]" = {}
            for row in cache.program_stats().values():
                modes[row["program"]] = modes.get(row["program"], 0) + 1
            stats.update(requests=len(results),
                         captures=int(cache.stats()["misses"]),
                         programs=modes)
        return results

    with lockwitness.witnessing() as witness:
        with _trace.observed(ObsConfig(enabled=True)):
            if arm_faults:
                # prob-0 site: the harness lock is VISITED on the
                # compile path (witnessing the cache->harness edge)
                # but never fires.
                with _faults.injected(FaultConfig(
                        seed=seed,
                        sites=(("serve.compile", 0.0, None),))):
                    _burst(witness)
            else:
                _burst(witness)
    return witness


def _witness_findings(witness, committed, edges_rel: str
                      ) -> "list[Finding]":
    findings = []
    known = {(e["from"], e["to"]) for e in committed}
    witnessed = witness.edges()
    for (a, b) in witnessed:
        if (a, b) not in known:
            findings.append(Finding(
                "DHQR602", edges_rel, 0,
                f"witnessed lock-order edge {a} -> {b} absent from the "
                "committed graph: the static pass (or the committed "
                "runtime edge list) is missing a real nesting",
                snippet=f"{a} -> {b}"))
    for violation in witness.violations():
        findings.append(Finding(
            "DHQR602", edges_rel, 0,
            f"lock-witness held-set violation: {violation}",
            snippet=str(violation)))
    cycle = find_cycle(witnessed)
    if cycle is not None:
        findings.append(Finding(
            "DHQR602", edges_rel, 0,
            "witnessed acquisition-order graph is cyclic: "
            + " -> ".join(cycle),
            snippet=" -> ".join(cycle)))
    return findings


def run_concurrency_pass(witness: bool = True,
                         edges_path: "str | None" = None,
                         device=None,
                         stats: "dict | None" = None) -> "list[Finding]":
    """The full DHQR6xx pass: static self-scan over the thread-shared
    tier, two-way committed-graph comparison, acyclicity, and (unless
    ``witness=False`` — the ``--fast`` twin) the runtime lock-witness
    gate over a seeded multi-threaded serving burst on ``device`` (None:
    the card). ``stats``, when given, receives the burst's figures
    (:func:`_witness_workload`) and its witnessed ``edges``, their
    ``lane_edges`` (those through a lane lock) and ``violations``."""
    import dhqr_tpu_torch

    pkg_root = os.path.dirname(os.path.abspath(dhqr_tpu_torch.__file__))
    repo_root = os.path.dirname(pkg_root)
    edges_path = edges_path or EDGES_PATH
    edges_rel = os.path.relpath(edges_path, repo_root)
    findings: "list[Finding]" = []
    extracted: "dict[tuple, str]" = {}
    for path in _scope_files(pkg_root):
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        file_findings, file_edges = _scan_text(text, rel)
        findings.extend(file_findings)
        for edge, site in file_edges.items():
            extracted.setdefault(edge, site)
    try:
        committed = load_edges(edges_path)
    except (OSError, ValueError) as e:
        findings.append(Finding(
            "DHQR602", edges_rel, 0,
            f"committed lock-order graph unreadable: {e}",
            snippet=""))
        return findings
    findings.extend(_graph_findings(extracted, committed, edges_rel))
    if witness:
        w = _witness_workload(arm_faults=True, device=device, stats=stats)
        findings.extend(_witness_findings(w, committed, edges_rel))
        if stats is not None:
            edges = w.edges()
            stats.update(
                edges=edges,
                lane_edges=[e for e in edges
                            if any(LANE_LOCK in node for node in e)],
                violations=len(w.violations()))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
