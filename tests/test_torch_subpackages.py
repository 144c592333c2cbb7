"""PyTorch port: the JAX package's import paths below the top level.

Every name in a JAX sub-module's ``__all__`` (or, where it has none, every
public function it defines) has a twin at the same dotted path in
``dhqr_tpu_torch``, or stands in ROADMAP.md's "Not ported by design" list
with a stub that raises ``NotPortedError`` and says why. The walk covers
the sub-packages ``ops``, ``parallel``, ``serve``, ``solvers``, ``utils``,
``obs``, ``tune``, ``armor``, ``numeric``, ``faults``, ``models`` and
``analysis``, and the CLI modules ``harness`` and ``_dryrun``. In
``analysis`` the source passes of ROADMAP item 18a and the graph passes of
item 18b (``jaxpr_pass``, ``comms_pass``, ``cost_model``, ``atlas``,
``pulse_smoke``, ``xray_smoke``) are twins: no name is a stub that waits
for an item.

The helpers that came with the walk are held to their JAX twins on the
same numpy inputs: ``random_problem`` bit for bit, ``accurate_sumsq`` /
``accurate_norm`` within 1 ulp-level relative error (1e-15, float64),
``solve_backward_error`` within 1e-12 relative; and ``DHQRConfig.from_env``
field for field under each ``DHQR_*`` variable.
"""

import dataclasses
import importlib
import inspect
import os
import pkgutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu.utils import testing as jtesting  # noqa: E402
from dhqr_tpu.utils.config import DHQRConfig as JConfig  # noqa: E402

from dhqr_tpu_torch.utils import testing  # noqa: E402
from dhqr_tpu_torch.utils.config import (  # noqa: E402
    DHQRConfig,
    NotPortedError,
)

ROADMAP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ROADMAP.md")

SUBPACKAGES = ("ops", "parallel", "serve", "solvers", "utils", "obs",
               "tune", "armor", "numeric", "faults", "models", "analysis")
# The graph passes of analysis/ (ROADMAP item 18b): ported, no stubs.
PENDING_18B = ("jaxpr_pass", "comms_pass", "cost_model", "atlas",
               "pulse_smoke", "xray_smoke")

# Whole JAX modules with no twin module, and the port's counterpart.
MODULES_BY_DESIGN = {
    "dhqr_tpu.ops.pallas_panel": "ops/hopper_panel.py + csrc/panel_qr.cu",
    "dhqr_tpu.utils.compat": "jax version shims",
}
# Names whose twin is a stub raising NotPortedError with the reason.
STUBS_BY_DESIGN = {
    "dhqr_tpu.parallel.column_sharding": ("parallel", "column_sharding"),
    "dhqr_tpu.parallel.replicated_sharding":
        ("parallel", "replicated_sharding"),
    "dhqr_tpu.parallel.mesh.column_sharding":
        ("parallel.mesh", "column_sharding"),
    "dhqr_tpu.parallel.mesh.replicated_sharding":
        ("parallel.mesh", "replicated_sharding"),
    "dhqr_tpu.obs.pulse.parse_trace_dir": ("obs.pulse", "parse_trace_dir"),
    "dhqr_tpu.utils.platform.cpu_requested":
        ("utils.platform", "cpu_requested"),
    "dhqr_tpu.utils.platform.force_cpu_platform":
        ("utils.platform", "force_cpu_platform"),
    "dhqr_tpu.utils.platform.enable_compile_cache":
        ("utils.platform", "enable_compile_cache"),
    "dhqr_tpu.analysis.cli._force_multidevice_env":
        ("analysis.cli", "_force_multidevice_env"),
    "dhqr_tpu.analysis.jaxpr_pass._ensure_cpu_backend":
        ("analysis.jaxpr_pass", "_ensure_cpu_backend"),
}


def _jax_modules():
    out = ["dhqr_tpu.harness", "dhqr_tpu._dryrun"]
    for sub in SUBPACKAGES:
        pkg = importlib.import_module(f"dhqr_tpu.{sub}")
        out.append(pkg.__name__)
        out += [f"{pkg.__name__}.{m.name}"
                for m in pkgutil.iter_modules(pkg.__path__)]
    return out


def _public_names(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and inspect.isfunction(v)
            and v.__module__ == mod.__name__]


MODULES = _jax_modules()


def _roadmap_by_design() -> str:
    text = open(ROADMAP, encoding="utf-8").read()
    start = text.index("**Not ported by design.**")
    return text[start:text.index("\n**", start + 10)]


@pytest.mark.parametrize("name", MODULES)
def test_every_reference_name_has_a_twin_at_its_path(name):
    mirror = name.replace("dhqr_tpu", "dhqr_tpu_torch", 1)
    if name in MODULES_BY_DESIGN:
        assert name.split(".", 1)[1].replace(".", "/") + ".py" in \
            _roadmap_by_design() or name.rsplit(".", 1)[1] in \
            _roadmap_by_design(), f"{name} is not listed by design"
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(mirror)
        return
    theirs = importlib.import_module(name)
    mine = importlib.import_module(mirror)
    missing = [n for n in _public_names(theirs) if not hasattr(mine, n)]
    assert not missing, f"{mirror} lacks {missing}"


@pytest.mark.parametrize("path", sorted(STUBS_BY_DESIGN))
def test_not_ported_by_design_stubs_raise_with_the_reason(path):
    sub, attr = STUBS_BY_DESIGN[path]
    fn = getattr(importlib.import_module(f"dhqr_tpu_torch.{sub}"), attr)
    assert f"{attr}" in _roadmap_by_design(), f"{path} not in ROADMAP.md"
    n_args = sum(p.default is inspect.Parameter.empty
                 for p in inspect.signature(fn).parameters.values())
    with pytest.raises(NotPortedError, match="no counterpart") as err:
        fn(*([None] * n_args))
    assert err.value.reason


@pytest.mark.parametrize("module", PENDING_18B)
def test_graph_pass_names_are_stubs_naming_item_18b(module):
    """Item 18b is ported: every public name of the graph passes is a
    function of the port's own analysis modules (none a stub), and the
    stub factory that named the item is gone."""
    theirs = importlib.import_module(f"dhqr_tpu.analysis.{module}")
    mine = importlib.import_module(f"dhqr_tpu_torch.analysis.{module}")
    names = _public_names(theirs)
    assert names, module
    for name in names:
        fn = getattr(mine, name)
        assert callable(fn), name
        assert fn.__module__ in (mine.__name__,
                                 "dhqr_tpu_torch.analysis.oplog"), name
    pending = importlib.import_module("dhqr_tpu_torch.analysis._pending")
    assert not hasattr(pending, "pending")


def test_source_pass_names_are_ported_not_stubbed():
    for module in ("findings", "ast_rules", "concurrency_pass", "api_check",
                   "cli"):
        theirs = importlib.import_module(f"dhqr_tpu.analysis.{module}")
        mine = importlib.import_module(f"dhqr_tpu_torch.analysis.{module}")
        for name in _public_names(theirs):
            assert getattr(mine, name).__module__ == mine.__name__, \
                (module, name)


# ------------------------------------------------------ helpers' parity


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
def test_random_problem_is_the_reference_problem_bit_for_bit(dtype):
    A, b = testing.random_problem(33, 7, np.dtype(dtype), seed=11)
    Aj, bj = jtesting.random_problem(33, 7, np.dtype(dtype), seed=11)
    assert A.dtype == Aj.dtype and b.dtype == bj.dtype
    assert A.tobytes() == Aj.tobytes() and b.tobytes() == bj.tobytes()


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_accurate_sumsq_and_norm_match_the_reference(dtype):
    from dhqr_tpu.ops import summation as jsum
    from dhqr_tpu_torch.ops import summation

    rng = np.random.default_rng(3)
    x = rng.standard_normal(1001) * 10.0 ** rng.integers(-6, 6, 1001)
    if dtype == "complex128":
        x = x + 1j * x[::-1]
    for mine, theirs in ((summation.accurate_sumsq, jsum.accurate_sumsq),
                         (summation.accurate_norm, jsum.accurate_norm)):
        a = float(mine(torch.as_tensor(x)))
        b = float(theirs(jnp.asarray(x)))
        assert abs(a - b) <= 1e-15 * abs(b)


def test_solve_backward_error_matches_the_reference():
    A, b = testing.random_problem(40, 9, np.float64, seed=5)
    x = np.linalg.lstsq(A, b, rcond=None)[0] + 1e-6
    mine = testing.solve_backward_error(torch.as_tensor(A), x, b)
    theirs = jtesting.solve_backward_error(A, x, b)
    assert abs(mine - theirs) <= 1e-12 * theirs


def test_trace_writes_a_chrome_trace_and_reads_profile_dir(tmp_path,
                                                           monkeypatch):
    from dhqr_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "a")):
        torch.ones(8) @ torch.ones(8)
    assert [p.suffix for p in (tmp_path / "a").iterdir()] == [".json"]
    monkeypatch.setenv("DHQR_OBS_PROFILE", str(tmp_path / "b"))
    with trace():
        torch.ones(8).sum()
    assert len(list((tmp_path / "b").iterdir())) == 1
    monkeypatch.delenv("DHQR_OBS_PROFILE")
    with pytest.raises(ValueError, match="DHQR_OBS_PROFILE"):
        with trace():
            pass


# ------------------------------------------ DHQRConfig.from_env (item 27)

ENV_CASES = [
    ("DHQR_LAYOUT", "cyclic"), ("DHQR_LAYOUT", "block"),
    ("DHQR_LOOKAHEAD", "1"), ("DHQR_LOOKAHEAD", "off"),
    ("DHQR_LOOKAHEAD", ""),
    ("DHQR_AGG_PANELS", "2"), ("DHQR_AGG_PANELS", "0"),
    ("DHQR_AGG_PANELS", ""),
    ("DHQR_OVERLAP_DEPTH", "3"), ("DHQR_OVERLAP_DEPTH", "0"),
    ("DHQR_MESH_AXIS", "rows"),
    ("DHQR_COMMS", "bf16"), ("DHQR_COMMS", "DCN:INT8"),
    ("DHQR_COMMS", "f32"), ("DHQR_COMMS", "none"), ("DHQR_COMMS", ""),
]


@pytest.mark.parametrize("var,value", ENV_CASES,
                         ids=[f"{v}={x or 'empty'}" for v, x in ENV_CASES])
def test_from_env_reads_the_mesh_variables_as_the_reference(var, value,
                                                             monkeypatch):
    monkeypatch.setenv(var, value)
    mine = dataclasses.asdict(DHQRConfig.from_env())
    theirs = dataclasses.asdict(JConfig.from_env())
    assert mine == theirs
    assert mine != dataclasses.asdict(DHQRConfig()) or value in (
        "block", "off", "", "0", "f32", "none")


def test_from_env_refuses_a_comms_typo_as_the_reference(monkeypatch):
    monkeypatch.setenv("DHQR_COMMS", "bf8")
    with pytest.raises(ValueError, match="comms must be one of"):
        JConfig.from_env()
    with pytest.raises(ValueError, match="comms must be one of"):
        DHQRConfig.from_env()
