"""Pass 1 — AST lint rules DHQR001-DHQR010 over the port's source: the
twin of ``dhqr_tpu/analysis/ast_rules.py``.

Each rule is a small class with an id, a scope predicate over the (posix)
file path, and a ``check(module)`` hook receiving a :class:`ModuleContext`
built once per file (parent links, the bodies a CUDA graph captures).
Every rule keeps its JAX package's ID; a rule that names a JAX construct
checks its PyTorch counterpart instead, and its docstring says how:

* DHQR001 — private ``torch._*`` imports, and any import of ``jax``,
  ``jaxlib`` or ``dhqr_tpu`` in the port;
* DHQR002 — a contraction (``@``, ``matmul``, ``mm``, ``bmm``, ``einsum``,
  ...) that does not go through ``ops/gemm.py`` at a named precision;
* DHQR003 — also torch's process-wide numeric switches (TF32, default
  dtype and device, deterministic algorithms);
* DHQR004 — a host sync inside a body a CUDA graph captures;
* DHQR005 — a ``torch.distributed`` collective without ``group=``;
* DHQR009 — a raw ``torch.distributed`` collective in ``parallel/``
  outside the wire seam;
* DHQR010 — a ``sharded_*`` entry point whose eager program dispatches
  outside the armor seam.

DHQR006 (swallowed exceptions) and DHQR008 (raw wall-clock reads) carry
over as they are. This module imports nothing but the standard library.
"""

from __future__ import annotations

import ast
import os

from dhqr_tpu_torch.analysis.findings import (
    Finding,
    apply_suppressions,
    missing_reason_findings,
    parse_suppressions,
)

# Directories never scanned (fixture files are deliberate violations).
EXCLUDED_PARTS = ("__pycache__", ".jax_cache", "fixtures")

# DHQR003's sanctioned config/env mutation sites: the test bring-up, the
# card's smoke run and the benchmarks (each a process that owns its
# environment), and the port's utils/platform.py, its one config
# authority.
SANCTIONED_CONFIG_PATHS = (
    "tests/conftest.py",
    "chip_smoke.py",
    "dhqr_tpu_torch/utils/platform.py",
)
SANCTIONED_CONFIG_DIRS = ("benchmarks/",)

_PACKAGE = "dhqr_tpu_torch"

#: Contractions (DHQR002): torch's, numpy's and their method spellings.
_CONTRACTION_ATTRS = {"matmul", "mm", "bmm", "einsum", "tensordot",
                      "addmm", "baddbmm", "dot", "vdot"}
#: The one module whose calls name their precision (``gemm.matmul(a, b,
#: "high")``).
_GEMM_MODULE = "gemm"
_GEMM_PRECISION_ARG = {"matmul": 2, "addmm": 3}

#: torch.distributed calls that are collectives (DHQR005) and, of those,
#: the ones that move data (DHQR009).
_DATA_COLLECTIVES = {
    "broadcast", "all_reduce", "reduce", "all_gather",
    "all_gather_into_tensor", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all", "all_to_all_single", "gather", "scatter", "send",
    "recv", "isend", "irecv", "batch_isend_irecv", "broadcast_object_list",
    "all_gather_object", "gather_object", "scatter_object_list",
}
_COLLECTIVES = _DATA_COLLECTIVES | {"barrier", "monitored_barrier"}

#: Host syncs in a captured body (DHQR004).
_HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_HOST_CASTS = {"float", "int", "bool"}
#: Python values a cast may read without a sync: shapes and sizes.
_HOST_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device"}
_HOST_SHAPE_CALLS = {"len", "numel", "size", "dim", "element_size"}

#: Process-wide numeric switches of torch (DHQR003): calls and
#: attribute assignments.
_TORCH_SWITCH_CALLS = {
    "torch.set_float32_matmul_precision",
    "torch.use_deterministic_algorithms",
    "torch.set_default_dtype",
    "torch.set_default_device",
}
_TORCH_SWITCH_ATTRS = {
    "torch.backends.cuda.matmul.allow_tf32",
    "torch.backends.cudnn.allow_tf32",
    "torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction",
    "torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction",
}


def _posix(path: str) -> str:
    return path.replace(os.sep, "/")


def _in_package(path: str) -> bool:
    return f"{_PACKAGE}/" in path or path.startswith(_PACKAGE)


def _call_name(node: ast.AST) -> str:
    """Rightmost identifier of a call target (Name or dotted Attribute)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted spelling ('torch.cuda.synchronize') for
    matching."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _module_aliases(tree: ast.Module, module: str) -> "set[str]":
    """Local names bound to ``module`` (``import torch.distributed as
    dist``, ``from torch import distributed as dist``), plus its dotted
    spelling."""
    parent, _, leaf = module.rpartition(".")
    out = {module}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == module and alias.asname:
                    out.add(alias.asname)
        elif isinstance(node, ast.ImportFrom) and node.module == parent:
            for alias in node.names:
                if alias.name == leaf:
                    out.add(alias.asname or leaf)
    return out


def _imported_names(tree: ast.Module, module: str,
                    names: "set[str]") -> "dict[str, str]":
    """Bare local name -> the ``module`` name it binds, for ``from module
    import name [as local]``."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for alias in node.names:
                if alias.name in names:
                    out[alias.asname or alias.name] = alias.name
    return out


class ModuleContext:
    """Everything the rules need, computed once per file."""

    def __init__(self, tree: ast.Module, lines: "list[str]", path: str):
        self.tree = tree
        self.lines = lines
        self.path = path
        self.parents: "dict[ast.AST, ast.AST]" = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.functions = self._collect_functions()
        self.captured_bodies = self._collect_captured_bodies()

    # -- context collectors --------------------------------------------------
    def _collect_functions(self):
        funcs: "dict[str, list]" = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.setdefault(node.name, []).append(node)
        return funcs

    def _collect_captured_bodies(self):
        """(FunctionDef | Lambda) nodes a CUDA graph captures: the programs
        the serve cache records (``serve/cache.py``, ``_capture``). A
        program builder is a function named ``*_program``; the closures it
        defines are the captured bodies, and so is a same-module function
        it wraps in ``partial(fn, ...)``. A function passed by name as the
        first argument of ``LoweredProgram(...)`` is one too, and so is a
        same-module function any of them calls by name (one level)."""
        bodies = set()
        for defs in self.functions.values():
            for fn in defs:
                if not fn.name.endswith("_program"):
                    continue
                for node in ast.walk(fn):
                    if node is fn:
                        continue
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef, ast.Lambda)):
                        bodies.add(node)
                    elif (isinstance(node, ast.Call)
                          and _call_name(node.func) == "partial"
                          and node.args
                          and isinstance(node.args[0], ast.Name)):
                        bodies.update(self.functions.get(node.args[0].id,
                                                         ()))
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Call)
                    and _call_name(node.func) == "LoweredProgram"
                    and node.args and isinstance(node.args[0], ast.Name)):
                bodies.update(self.functions.get(node.args[0].id, ()))
        # one call level: a same-module function a captured body calls by
        # name runs inside the capture too
        called = set()
        for body in bodies:
            for node in ast.walk(body):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name):
                    called.update(self.functions.get(node.func.id, ()))
        return bodies | called

    # -- shared helpers ------------------------------------------------------
    def inside_import_guard(self, node: ast.AST) -> bool:
        """Is ``node`` within a try: whose handlers catch ImportError (or
        broader)? That is the sanctioned spelling for version-dependent
        private-torch access."""
        guard_names = {"ImportError", "ModuleNotFoundError", "Exception"}
        cur = node
        while cur in self.parents:
            parent = self.parents[cur]
            if isinstance(parent, ast.Try) and cur in parent.body:
                for handler in parent.handlers:
                    types = []
                    if handler.type is None:
                        return True
                    if isinstance(handler.type, ast.Tuple):
                        types = handler.type.elts
                    else:
                        types = [handler.type]
                    for t in types:
                        if _call_name(t) in guard_names:
                            return True
            cur = parent
        return False

    def subtree_nodes(self, roots):
        """All AST nodes inside the given function/lambda roots."""
        seen = set()
        for root in roots:
            for node in ast.walk(root):
                seen.add(node)
        return seen


class Rule:
    id = "DHQR000"
    title = ""

    def applies(self, path: str) -> bool:
        return True

    def check(self, ctx: ModuleContext) -> "list[Finding]":
        raise NotImplementedError

    def _finding(self, ctx: ModuleContext, node: ast.AST, message: str):
        line = getattr(node, "lineno", 0)
        snippet = ctx.lines[line - 1].strip() if 0 < line <= len(ctx.lines) \
            else ""
        return Finding(self.id, ctx.path, line, message, snippet=snippet)


class PrivateImports(Rule):
    """DHQR001 — two import rules of the port.

    (a) A private module of torch (``torch._C``, ``torch._dynamo``,
    ``torch.utils._python_dispatch``: any dotted part after ``torch``
    that starts with ``_``) may vanish in any release, turning every
    import of the importing module into a crash. Allowed only in
    ``utils/compat.py`` (the one named shim module) or behind a
    try/except ImportError that degrades gracefully — the JAX rule's
    ``jax._src``, in torch's spelling.

    (b) The port imports nothing of JAX: an import of ``jax``, ``jaxlib``
    or ``dhqr_tpu`` in ``dhqr_tpu_torch/`` or ``chip_smoke.py`` is a
    finding, guarded or not (the tests are the one place that imports
    both packages)."""

    id = "DHQR001"
    title = ("unguarded private torch._* import, or a jax/dhqr_tpu "
             "import in the port")

    _FOREIGN = ("jax", "jaxlib", "dhqr_tpu")

    def applies(self, path: str) -> bool:
        return not path.endswith("utils/compat.py")

    @staticmethod
    def _private_torch(module: str) -> bool:
        parts = module.split(".")
        return parts[0] == "torch" and any(p.startswith("_")
                                           for p in parts[1:])

    def _foreign(self, module: str) -> bool:
        return module.split(".")[0] in self._FOREIGN

    def check(self, ctx):
        port = _in_package(ctx.path) or ctx.path == "chip_smoke.py" \
            or ctx.path.endswith("/chip_smoke.py")
        out = []
        for node in ast.walk(ctx.tree):
            modules = []
            if isinstance(node, ast.Import):
                modules = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                base = node.module or ""
                modules = [base] + [f"{base}.{a.name}" for a in node.names]
            for module in modules:
                if port and self._foreign(module):
                    out.append(self._finding(
                        ctx, node,
                        f"import of '{module}' in the port: dhqr_tpu_torch "
                        "and chip_smoke.py import nothing of jax or of the "
                        "JAX package (copy what is needed instead)",
                    ))
                    break
                if self._private_torch(module) \
                        and not ctx.inside_import_guard(node):
                    out.append(self._finding(
                        ctx, node,
                        f"unguarded private import '{module}': private "
                        "torch API must live in utils/compat.py or behind "
                        "try/except ImportError with a graceful fallback",
                    ))
                    break
        return out


class UnannotatedContractions(Rule):
    """DHQR002 — every contraction names its precision. The port's
    counterpart of ``jnp.matmul(..., precision=p)`` is
    ``ops.gemm.matmul(a, b, p)`` / ``gemm.addmm(c, a, b, p)``: "highest"
    is full FP32, "high" and "default" are three and one bf16 passes. A
    bare ``@``, ``torch.matmul``, ``mm``, ``bmm``, ``einsum``,
    ``tensordot``, ``addmm``, ``baddbmm``, ``dot`` or ``vdot`` always
    runs full FP32 (the port never enables TF32), so where the JAX
    twin names a policy precision the bare call silently computes a
    different product. Route it through ``ops/gemm`` at the twin's
    precision (a gemm call passes the precision explicitly), or
    suppress with the reason it is not a policy product (an f64 check,
    host numpy, a plain version). ``ops/gemm.py`` itself is exempt."""

    id = "DHQR002"
    title = "contraction outside ops/gemm at a named precision"

    def applies(self, path: str) -> bool:
        return _in_package(path) and not path.endswith("ops/gemm.py")

    def check(self, ctx):
        gemm_names = _imported_names(ctx.tree, f"{_PACKAGE}.ops.gemm",
                                     set(_GEMM_PRECISION_ARG))
        out = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                          ast.MatMult):
                out.append(self._finding(
                    ctx, node,
                    "'@' names no precision — use ops.gemm.matmul(a, b, "
                    "precision) at the JAX twin's precision, or suppress "
                    "with the reason this is not a policy product",
                ))
                continue
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            prefix = _dotted(node.func).rpartition(".")[0]
            via_gemm = prefix.split(".")[-1].lstrip("_") == _GEMM_MODULE \
                if prefix else (isinstance(node.func, ast.Name)
                                and node.func.id in gemm_names)
            if via_gemm:
                target = gemm_names.get(name, name)
                idx = _GEMM_PRECISION_ARG.get(target)
                if idx is None or len(node.args) > idx or any(
                        kw.arg == "precision" for kw in node.keywords):
                    continue
                out.append(self._finding(
                    ctx, node,
                    f"gemm.{target}() without its precision argument: "
                    "pass the precision the JAX twin names",
                ))
                continue
            if name not in _CONTRACTION_ATTRS:
                continue
            out.append(self._finding(
                ctx, node,
                f"{name}() names no precision — route it through "
                "ops.gemm at the JAX twin's precision, or suppress with "
                "the reason this is not a policy product",
            ))
        return out


class GlobalConfigMutation(Rule):
    """DHQR003 — env mutation and process-wide switches are global state:
    in a library they race every concurrent call (``serve/scheduler.py``
    dispatches from worker threads) and leak into the caller's process.
    The JAX rule's ``jax.config.update`` and ``os.environ`` writes carry
    over; torch's numeric switches join them: ``torch.backends.cuda.
    matmul.allow_tf32`` / ``torch.backends.cudnn.allow_tf32`` (and the
    reduced-precision reduction flags) assigned, and
    ``torch.set_float32_matmul_precision``,
    ``torch.use_deterministic_algorithms``, ``torch.set_default_dtype``
    and ``torch.set_default_device`` called — the "Precision per call"
    ground rule. Only process-owning entry points may mutate them:
    tests/conftest.py, chip_smoke.py, benchmarks/, and the port's
    utils/platform.py."""

    id = "DHQR003"
    title = "process-global config/env mutation outside sanctioned modules"

    def applies(self, path: str) -> bool:
        # Anchored matching: 'tests/test_chip_smoke.py' must NOT inherit
        # chip_smoke.py's sanction, nor 'my_benchmarks/' the benchmarks/
        # one.
        if any(path == p or path.endswith("/" + p)
               for p in SANCTIONED_CONFIG_PATHS):
            return False
        parts = path.split("/")
        return not any(d.rstrip("/") in parts[:-1]
                       for d in SANCTIONED_CONFIG_DIRS)

    @staticmethod
    def _is_environ(node: ast.AST) -> bool:
        return isinstance(node, ast.Attribute) and node.attr == "environ"

    def check(self, ctx):
        out = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                if dotted.endswith("config.update"):
                    out.append(self._finding(
                        ctx, node,
                        "jax.config.update mutates process-global state: "
                        "route through utils/platform.py (or suppress: "
                        "process-owning entry points only)",
                    ))
                elif dotted in _TORCH_SWITCH_CALLS:
                    out.append(self._finding(
                        ctx, node,
                        f"{dotted}() flips a process-wide numeric switch: "
                        "pick the precision per call (ops.gemm) — "
                        "sanctioned modules only",
                    ))
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in ("setdefault", "update", "pop",
                                             "clear")
                      and self._is_environ(node.func.value)):
                    out.append(self._finding(
                        ctx, node,
                        f"os.environ.{node.func.attr}() mutates the "
                        "process environment: sanctioned modules only",
                    ))
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr == "putenv"):
                    out.append(self._finding(
                        ctx, node,
                        "os.putenv mutates the process environment: "
                        "sanctioned modules only",
                    ))
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if (isinstance(t, ast.Subscript)
                            and self._is_environ(t.value)):
                        out.append(self._finding(
                            ctx, node,
                            "os.environ[...] assignment mutates the "
                            "process environment: sanctioned modules only",
                        ))
                    elif _dotted(t) in _TORCH_SWITCH_ATTRS:
                        out.append(self._finding(
                            ctx, node,
                            f"{_dotted(t)} = ... flips a process-wide "
                            "numeric switch: pick the precision per call "
                            "(ops.gemm) — sanctioned modules only",
                        ))
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if (isinstance(t, ast.Subscript)
                            and self._is_environ(t.value)):
                        out.append(self._finding(
                            ctx, node,
                            "del os.environ[...] mutates the process "
                            "environment: sanctioned modules only",
                        ))
        return out


class HostSyncInCapturedBody(Rule):
    """DHQR004 — a host sync inside a body a CUDA graph captures. The serve
    tier records each bucket program once (``serve/cache.py``,
    ``_capture``) and replays it; the JAX rule's traced body is the
    port's captured body: the closures of the program builders
    (``serve/engine.py`` ``_key_program`` / ``bucket_program``,
    ``serve/scheduler.py`` ``dispatch_program``, ``solvers/update.py``
    ``update_program`` / ``solve_program``, ``solvers/sketch.py``
    ``batched_sketch_program``: every function named ``*_program``).
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, a
    ``float()``/``int()``/``bool()`` of a tensor (a cast of a shape or
    size is host arithmetic and passes) and ``torch.cuda.synchronize``
    / ``.synchronize()`` fail the capture, or — run eager — force a host
    round trip per call on a path that must stay on the device."""

    id = "DHQR004"
    title = "host sync inside a CUDA-graph-captured body"

    @staticmethod
    def _host_value(node: ast.AST) -> bool:
        """Is ``node`` host arithmetic a cast may read: a constant, or an
        expression over shapes and sizes?"""
        if isinstance(node, ast.Constant):
            return True
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) \
                    and sub.attr in _HOST_SHAPE_ATTRS:
                return True
            if isinstance(sub, ast.Call) \
                    and _call_name(sub.func) in _HOST_SHAPE_CALLS:
                return True
        return False

    def check(self, ctx):
        if not ctx.captured_bodies:
            return []
        out = []
        for node in ctx.subtree_nodes(ctx.captured_bodies):
            if not isinstance(node, ast.Call):
                continue
            fname = _call_name(node.func)
            if isinstance(node.func, ast.Name) and fname in _HOST_CASTS \
                    and node.args and not self._host_value(node.args[0]):
                out.append(self._finding(
                    ctx, node,
                    f"{fname}() of a tensor inside a captured body is a "
                    "host readback — keep the value on the device",
                ))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_SYNC_ATTRS:
                out.append(self._finding(
                    ctx, node,
                    f".{node.func.attr}() inside a captured body is a host "
                    "sync — keep the value on the device",
                ))
        return out


class CollectiveGroup(Rule):
    """DHQR005 — every ``torch.distributed`` collective passes an explicit
    ``group=``, taken from the mesh (``mesh.group``). The JAX rule's
    hazard was a hard-coded axis name that matches no mesh axis; the
    port's is the default group: a collective without ``group=`` runs
    over the WORLD, so on a sub-mesh (the pod mesh's tiers, a row mesh
    over some ranks) it waits for ranks that never join — a hang, not
    an error. ``group=None`` spells the same default and is flagged
    too."""

    id = "DHQR005"
    title = "torch.distributed collective without an explicit group="

    def check(self, ctx):
        dist = _module_aliases(ctx.tree, "torch.distributed")
        bare = _imported_names(ctx.tree, "torch.distributed", _COLLECTIVES)
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            prefix = _dotted(node.func).rpartition(".")[0]
            if not ((prefix in dist and name in _COLLECTIVES)
                    or (isinstance(node.func, ast.Name) and name in bare)):
                continue
            group = [kw.value for kw in node.keywords if kw.arg == "group"]
            if group and not (isinstance(group[0], ast.Constant)
                              and group[0].value is None):
                continue
            out.append(self._finding(
                ctx, node,
                f"{_dotted(node.func)}() without group=: it runs over the "
                "WORLD group — pass the mesh's group (mesh.group)",
            ))
        return out


class SwallowedException(Rule):
    """DHQR006 — an ``except ...: pass`` (or bare-``...`` body) in
    package code silently discards a failure: the fault model depends on
    every failure path SURFACING typed (retry, quarantine, bisection,
    worker respawn all key on seeing the exception), and one swallowed
    ``except`` upstream turns a designed failure into a silent wrong
    answer or a hang. Where discarding really is the intent (a
    best-effort cleanup, an optional probe), suppress with the reason —
    the reason is the documentation the bare ``pass`` was hiding."""

    id = "DHQR006"
    title = "swallowed exception (except: pass) without a suppression"

    def applies(self, path: str) -> bool:
        return _in_package(path)

    @staticmethod
    def _is_noop(stmt: ast.stmt) -> bool:
        return isinstance(stmt, ast.Pass) or (
            isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is Ellipsis)

    def check(self, ctx):
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not all(self._is_noop(s) for s in node.body):
                continue
            caught = "everything" if node.type is None else (
                _call_name(node.type) or "multiple exception types")
            out.append(self._finding(
                ctx, node,
                f"except block catching {caught} swallows the error "
                "with a bare pass — handle it, reraise typed, or "
                "suppress with the reason discarding is safe here",
            ))
        return out


class UnguardedCholesky(Rule):
    """DHQR007 — every Cholesky in package code routes through the one
    guarded wrapper, ``dhqr_tpu_torch.numeric.guards.checked_cholesky``.
    ``torch.linalg.cholesky`` raises on a non-positive-definite input
    and ``cholesky_ex`` returns a partial factor with an info code; the
    wrapper turns either into the JAX package's contract (NaN from the
    first failed pivot on, which the CholeskyQR engines and the ladder
    gate on). A direct call opts out of that contract. Every spelling is
    flagged: ``*.linalg.cholesky`` / ``cholesky_ex``, ``torch.cholesky``,
    a bare name bound by ``from <...linalg...> import cholesky``, and a
    linalg module alias."""

    id = "DHQR007"
    title = "direct cholesky call outside numeric.guards.checked_cholesky"

    _NAMES = {"cholesky", "cholesky_ex"}

    def applies(self, path: str) -> bool:
        # The wrapper module itself is the one sanctioned call site.
        return _in_package(path) and not path.endswith("numeric/guards.py")

    def check(self, ctx):
        flagged_names: "set[str]" = set()
        module_aliases: "set[str]" = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if "linalg" in (node.module or "") \
                            and alias.name in self._NAMES:
                        flagged_names.add(alias.asname or alias.name)
                    elif alias.name == "linalg" and alias.asname:
                        module_aliases.add(alias.asname)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if "linalg" in alias.name and alias.asname:
                        module_aliases.add(alias.asname)
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            dotted = _dotted(node.func)
            if isinstance(node.func, ast.Name):
                if name not in flagged_names:
                    continue  # a local wrapper named cholesky
            elif name in self._NAMES:
                prefix = dotted.rpartition(".")[0]
                if not (prefix.endswith("linalg") or prefix == "torch"
                        or prefix in module_aliases):
                    continue  # checked_cholesky-style wrappers pass
            else:
                continue
            out.append(self._finding(
                ctx, node,
                f"direct {dotted}() call: route through "
                "dhqr_tpu_torch.numeric.guards.checked_cholesky (the "
                "guarded wrapper carrying the NaN-breakdown contract), or "
                "suppress with the reason breakdown is impossible here",
            ))
        return out


class RawWallClock(Rule):
    """DHQR008 — a raw wall-clock READ (``time.time()`` /
    ``time.monotonic()`` / ``time.perf_counter()`` and their ``_ns``
    twins) in package code bypasses the injectable-clock seams the
    stack is built on: the scheduler, the executable cache's
    quarantine, the fault harness and the trace recorder all take
    ``clock=`` precisely so deadline/backoff/cooldown/span decisions
    replay deterministically under a fake clock in tests and the dry
    run. The sanctioned spellings are (a) passing the callable as an
    injectable default (``clock=time.monotonic`` — a reference, not a
    read; this rule flags CALLS only) and (b) a reasoned suppression
    where a real wall clock IS the point (measuring actual device
    seconds, bounding a drain against real hangs)."""

    id = "DHQR008"
    title = "raw wall-clock read outside an injectable-clock seam"

    _CLOCK_NAMES = {
        "time", "monotonic", "perf_counter",
        "time_ns", "monotonic_ns", "perf_counter_ns",
    }

    def applies(self, path: str) -> bool:
        return _in_package(path)

    def check(self, ctx):
        flagged_names: "set[str]" = set()
        module_aliases: "set[str]" = {"time"}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in self._CLOCK_NAMES:
                        flagged_names.add(alias.asname or alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "time" and alias.asname:
                        module_aliases.add(alias.asname)
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            prefix, _, attr = dotted.rpartition(".")
            via_module = prefix in module_aliases \
                and attr in self._CLOCK_NAMES
            bare = isinstance(node.func, ast.Name) \
                and node.func.id in flagged_names
            if not via_module and not bare:
                continue
            out.append(self._finding(
                ctx, node,
                f"raw wall-clock read {dotted or _call_name(node.func)}(): "
                "route through the subsystem's injectable clock "
                "(clock=/self._clock) so fake-clock tests stay "
                "deterministic, or suppress with the reason a real "
                "wall clock is the point here",
            ))
        return out


class RawCollectiveOutsideSeam(Rule):
    """DHQR009 — a raw data-moving ``torch.distributed`` collective in the
    sharded tier (``dhqr_tpu_torch/parallel/``) bypasses the wire seam
    (``parallel/wire.py``), the ONE place a collective's wire format is
    chosen, its integrity tag attached and its bytes entered in the
    census: ``wire_broadcast`` / ``wire_all_reduce`` / ``wire_all_gather``
    are verbatim passthroughs at ``comms=None`` and bf16/int8 quantizers
    on the compressed rungs. A raw ``dist.broadcast`` on a panel path is
    a collective the ``comms`` policy field can never compress and the
    census never counts. The seam module itself is the sanctioned call
    site; ``barrier`` moves no words."""

    id = "DHQR009"
    title = "raw torch.distributed collective in the sharded tier outside " \
        "the wire seam"

    def applies(self, path: str) -> bool:
        return ("parallel/" in path
                and _in_package(path)
                and not path.endswith("parallel/wire.py"))

    def check(self, ctx):
        dist = _module_aliases(ctx.tree, "torch.distributed")
        bare = _imported_names(ctx.tree, "torch.distributed",
                               _DATA_COLLECTIVES)
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            dotted = _dotted(node.func)
            prefix = dotted.rpartition(".")[0]
            if not ((prefix in dist and name in _DATA_COLLECTIVES)
                    or (isinstance(node.func, ast.Name) and name in bare)):
                continue  # wire_broadcast-style wrappers pass
            out.append(self._finding(
                ctx, node,
                f"raw collective {dotted}() on a sharded-tier path: "
                "route through dhqr_tpu_torch.parallel.wire (a verbatim "
                "passthrough at comms=None) so the comms policy field can "
                "compress it and the wire census counts it, or suppress "
                "with the reason the wire format cannot apply",
            ))
        return out


class ShardedDispatchOutsideArmor(Rule):
    """DHQR010 — a sharded-tier entry point dispatches collective results
    without the armor verification seam. The ``sharded_*`` entry points
    in ``dhqr_tpu_torch/parallel/`` are the ONE place factor-carrying
    collective results surface to callers; each one that builds a
    program must route its dispatch through ``armor.checked_dispatch``
    (or ``armor.checked_solve``, the solve engines' seam over it) so
    that, when armed, every factor/solve crossing the mesh is
    checksum-verified and the recovery ladder applies.

    The port's engines are eager, so "builds a program" reads: the entry
    point (or a closure it defines) runs the rank's eager program
    through ``observed_dispatch`` (the pulse seam every mesh dispatch
    passes), or calls a ``_build_*`` function as in the JAX package.
    It is armored when it calls ``checked_dispatch`` / ``checked_solve``
    itself or through a function of the same module that does (one
    call level: ``sharded_qr._factor_result``). Internal chaining
    helpers (no dispatch of their own) are exempt — they verify at the
    top level."""

    id = "DHQR010"
    title = ("sharded entry point dispatches collective results "
             "outside the armor verification seam")

    _SEAMS = {"checked_dispatch", "checked_solve"}

    def applies(self, path: str) -> bool:
        return ("parallel/" in path
                and _in_package(path)
                and not path.endswith("parallel/wire.py"))

    def _calls_seam(self, fn) -> bool:
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call) \
                    and _call_name(sub.func) in self._SEAMS:
                return True
        return False

    def check(self, ctx):
        seam_helpers = {
            fn.name for fn in ctx.tree.body
            if isinstance(fn, ast.FunctionDef) and self._calls_seam(fn)}
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.FunctionDef) \
                    or not node.name.startswith("sharded_"):
                continue
            builds = False
            armored = False
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                name = _call_name(sub.func)
                if name == "observed_dispatch" or name.startswith("_build_"):
                    builds = True
                if name in self._SEAMS or (isinstance(sub.func, ast.Name)
                                           and name in seam_helpers):
                    armored = True
            if builds and not armored:
                out.append(self._finding(
                    ctx, node,
                    f"sharded entry point {node.name}() dispatches a "
                    "mesh program (observed_dispatch) but never routes it "
                    "through armor.checked_dispatch / checked_solve: when "
                    "the armor tier is armed this dispatch returns "
                    "unverified collective results — wrap the dispatch "
                    "in the seam behind the armor.active() None check, "
                    "or suppress with the reason no factor-carrying "
                    "result crosses here",
                ))
        return out


AST_RULES = (
    PrivateImports(),
    UnannotatedContractions(),
    GlobalConfigMutation(),
    HostSyncInCapturedBody(),
    CollectiveGroup(),
    SwallowedException(),
    UnguardedCholesky(),
    RawWallClock(),
    RawCollectiveOutsideSeam(),
    ShardedDispatchOutsideArmor(),
)


def scan_source(text: str, path: str, rules=AST_RULES) -> "list[Finding]":
    """Run the AST rules over one file's source. ``path`` is the posix
    path used for scoping and display — tests pass virtual paths so
    inline sources exercise package-scoped rules."""
    path = _posix(path)
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding("DHQR000", path, e.lineno or 0,
                        f"syntax error: {e.msg}")]
    lines = text.splitlines()
    ctx = ModuleContext(tree, lines, path)
    findings = []
    for rule in rules:
        if rule.applies(path):
            findings.extend(rule.check(ctx))
    findings.sort(key=lambda f: (f.line, f.rule))
    out = apply_suppressions(findings, parse_suppressions(lines))
    # After apply_suppressions, and never routed through it: a
    # reason-less `# dhqr: ignore[DHQR000]` must not suppress its own
    # missing-reason report (warn-only, severity="warning").
    out.extend(missing_reason_findings(lines, path))
    return out


def iter_python_files(paths):
    """Expand files/directories into .py files, skipping excluded parts.

    A named path that does not exist raises: a typo'd CI target must
    fail loudly, not scan zero files and report a green gate."""
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"lint target {path!r} is neither a file nor a directory")
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in EXCLUDED_PARTS)
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def scan_paths(paths, rules=AST_RULES, rel_to=None) -> "list[Finding]":
    """Scan files/directories; display paths are made relative to
    ``rel_to`` (default: cwd) where possible."""
    rel_to = rel_to or os.getcwd()
    findings = []
    for fpath in iter_python_files(paths):
        try:
            rel = os.path.relpath(fpath, rel_to)
        except ValueError:
            rel = fpath
        if rel.startswith(".."):
            rel = fpath
        with open(fpath, "r", encoding="utf-8") as fh:
            text = fh.read()
        findings.extend(scan_source(text, _posix(rel), rules))
    return findings
