"""PyTorch port: the rules the port keeps — it imports neither JAX nor the
JAX package, it runs on the card unless told otherwise, it never falls
back, and its main path calls no library factorization."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dhqr_tpu_torch as dt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "dhqr_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_importing_the_port_loads_no_jax():
    """Importing the port loads no JAX module and builds or loads no kernel
    library."""
    code = ("import sys, dhqr_tpu_torch, dhqr_tpu_torch.interop; "
            "from dhqr_tpu_torch.ops import _build; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'dhqr_tpu' or "
            "m.startswith('dhqr_tpu.')] + list(_build._LIBS); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_sources_import_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "dhqr_tpu"), (path, mod)


# The one library QR the port calls: the reconstruct panel engine's
# explicit QR, as the JAX engine calls jnp.linalg.qr there (only
# panel_impl="reconstruct[:<chunk>]" reaches it).
_LIBRARY_QR_CALLERS = {("householder.py", "_explicit_qr_tree"),
                       ("householder.py", "_panel_qr_reconstruct")}


def _torch_attributes(path):
    """(enclosing function name, attribute node) of every ``torch.*``
    attribute in ``path``."""
    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Attribute) and \
                    ast.unparse(child.value).startswith("torch"):
                yield name, child
            yield from walk(child, name)

    yield from walk(ast.parse(open(path, encoding="utf-8").read()), None)


def test_main_path_calls_no_library_factorization():
    """No torch.geqrf / torch.linalg.qr / torch.linalg.lstsq /
    torch.compile in the package (chip_smoke.py times some of them as
    yardsticks; the package never calls them), except ``torch.linalg.qr``
    in the reconstruct panel engine's two functions."""
    banned = {"geqrf", "qr", "lstsq", "compile", "householder_product",
              "orgqr", "ormqr"}
    allowed = []
    for path in _port_sources():
        if path.endswith("chip_smoke.py"):
            continue
        for func, node in _torch_attributes(path):
            if node.attr not in banned:
                continue
            where = (os.path.basename(path), func)
            if node.attr == "qr" and where in _LIBRARY_QR_CALLERS:
                allowed.append(where)
                continue
            raise AssertionError((path, func, ast.unparse(node)))
    assert set(allowed) == _LIBRARY_QR_CALLERS


def test_default_paths_reach_no_library_factorization(monkeypatch):
    """With every library factorization made to raise, the default ``qr``
    (both panel routes) and ``lstsq`` (and its schedules) still run."""
    def refuse(*args, **kwargs):
        raise AssertionError("a library factorization was called")

    for mod, name in ((torch.linalg, "qr"), (torch.linalg, "lstsq"),
                      (torch, "geqrf"), (torch.linalg, "householder_product"),
                      (torch, "ormqr"), (torch, "orgqr")):
        monkeypatch.setattr(mod, name, refuse)
    A = np.random.default_rng(1).random((90, 70)).astype(np.float32)
    b = A[:, 0] + 1
    for kw in ({}, {"use_pallas": "always"}, {"lookahead": True},
               {"agg_panels": 2}):
        dt.qr(A, block_size=16, device="cpu", **kw).solve(b)
        dt.lstsq(A, b, block_size=16, device="cpu", **kw)
    with pytest.raises(AssertionError, match="library factorization"):
        dt.qr(A, panel_impl="reconstruct", device="cpu")


def test_no_cuda_means_asking_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = np.random.default_rng(0).random((20, 10)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dt.qr(A)
    with pytest.raises(RuntimeError):
        dt.lstsq(A, A[:, 0])
    with pytest.raises(RuntimeError):
        dt.householder_qr(A, device="cuda")
    assert dt.qr(A, device="cpu").H.device.type == "cpu"


def test_tf32_is_refused(monkeypatch):
    monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "high")
    A = np.eye(8, dtype=np.float32)
    with pytest.raises(RuntimeError, match="FP32"):
        dt.qr(A, device="cpu")


def test_facade_exports():
    import dhqr_tpu

    for name in dt.__all__:
        assert hasattr(dt, name), name
    wanted = {"qr", "lstsq", "solve", "QRFactorization", "householder_qr",
              "blocked_householder_qr", "apply_qt", "apply_q",
              "back_substitute", "solve_least_squares", "alphafactor",
              "DHQRConfig", "__version__",
              "qr_explicit", "lstsq_diff", "tsqr_lstsq", "tsqr_r",
              "cholesky_qr2", "cholesky_qr_lstsq", "NumericalError",
              "NonFiniteInput", "Breakdown", "IllConditioned",
              "ResidualGateFailed", "PrecisionPolicy", "PRECISION_POLICIES",
              "POLICY_LADDER", "resolve_policy", "sketched_lstsq",
              "SketchConfig", "TierAxes", "pod_mesh", "global_pod_mesh",
              "PulseReport"}
    assert wanted <= set(dt.__all__)
    assert (wanted - {"DHQRConfig"}) <= set(dhqr_tpu.__all__) | {"__version__"}
    # the distributed tier: the names of dhqr_tpu.parallel that the port
    # runs, plus its mesh type (JAX's NamedSharding helpers have no twin)
    import dhqr_tpu.parallel as jpar

    for name in dt.parallel.__all__:
        assert hasattr(dt.parallel, name), name
    parallel = {"ColumnBlock", "area_balanced_splits", "column_block_ranges",
                "local_column_block", "column_mesh", "row_mesh",
                "sharded_householder_qr", "sharded_blocked_qr",
                "sharded_solve", "sharded_lstsq", "sharded_tsqr_lstsq",
                "sharded_cholqr_lstsq", "initialize", "global_column_mesh",
                "global_row_mesh", "process_info"}
    pod = {"TierAxes", "pod_mesh", "global_pod_mesh"}
    assert set(dt.parallel.__all__) == parallel | pod | {"ColumnMesh",
                                                          "PodMesh"}
    assert parallel <= set(jpar.__all__)
    assert pod <= set(dhqr_tpu.__all__)  # exported at the JAX top level


# The collectives of torch.distributed; in the port's parallel/ package
# only wire.py calls them (the JAX package's DHQR009 rule for its wire).
_COLLECTIVES = {"broadcast", "all_reduce", "all_gather", "reduce_scatter",
                "all_to_all", "reduce", "gather", "scatter", "barrier",
                "send", "recv", "isend", "irecv", "all_gather_into_tensor",
                "reduce_scatter_tensor", "all_to_all_single",
                "broadcast_object_list", "all_gather_object",
                "batch_isend_irecv"}


def test_only_the_wire_calls_collectives():
    parallel = os.path.join(PORT, "parallel")
    seen = []
    for name in sorted(os.listdir(parallel)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(parallel, name),
                              encoding="utf-8").read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in _COLLECTIVES \
                    and ast.unparse(node.value) in ("dist",
                                                    "torch.distributed"):
                seen.append((name, ast.unparse(node)))
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("torch.distributed"):
                assert not {a.name for a in node.names} & _COLLECTIVES, name
    assert seen and {name for name, _ in seen} == {"wire.py"}, seen

