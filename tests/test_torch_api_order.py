"""PyTorch port: the reference's API order — ``lstsq_diff``'s parameters
and ``QRFactorization``'s fields in the JAX package's order, with its
names — and the rank launcher's device rule (None means the card).

Tolerances: x within 1e-10 relative in float64 for the same positional or
keyword call in both packages; 1e-5 in float32 where the panels run the
kernel's plain version in the port and the Pallas interpreter in the JAX
package.
"""

import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
from dhqr_tpu.utils.testing import random_problem  # noqa: E402

import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu_torch.interop import to_numpy  # noqa: E402
from dhqr_tpu_torch.ops import blocked  # noqa: E402
from dhqr_tpu_torch.parallel import _ranks  # noqa: E402


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ----------------------------------------------------- lstsq_diff (item 2)


def test_lstsq_diff_parameters_in_the_reference_order():
    mine = list(inspect.signature(dt.lstsq_diff).parameters)
    theirs = list(inspect.signature(dhqr_tpu.lstsq_diff).parameters)
    assert mine[:len(theirs)] == theirs
    assert mine[len(theirs):] == ["device", "use_pallas"]
    for name in ("device", "use_pallas"):
        assert inspect.signature(dt.lstsq_diff).parameters[name].kind \
            is inspect.Parameter.KEYWORD_ONLY


POSITIONAL = (4, "highest", False, False, "accurate", "loop", 1)
KEYWORDS = dict(block_size=4, precision="highest", pallas=False,
                pallas_interpret=False, norm="accurate", panel_impl="loop",
                refine=1, pallas_flat=None, trailing_precision=None,
                lookahead=False, agg_panels=None, apply_precision=None)


@pytest.mark.parametrize("call", ["positional", "keywords"])
def test_lstsq_diff_same_call_same_answer(call):
    A, b = random_problem(48, 12, np.float64, seed=91)
    if call == "positional":
        x = dt.lstsq_diff(A, b, *POSITIONAL, device="cpu")
        xj = dhqr_tpu.lstsq_diff(jnp.asarray(A), jnp.asarray(b), *POSITIONAL)
    else:
        x = dt.lstsq_diff(A, b, **KEYWORDS, device="cpu")
        xj = dhqr_tpu.lstsq_diff(jnp.asarray(A), jnp.asarray(b), **KEYWORDS)
    assert _rel(to_numpy(x), np.asarray(xj)) <= 1e-10


def test_lstsq_diff_interpreted_kernel_with_a_flat_cap(fresh_compile_state):
    """``pallas=True, pallas_interpret=True, pallas_flat=4`` (positional):
    the kernel route with its plain version on 4-wide leaves here, the
    Pallas interpreter there."""
    A, b = random_problem(48, 12, np.float32, seed=92)
    args = (8, "highest", True, True, "accurate", "loop", 0, 4)
    x = dt.lstsq_diff(A, b, *args, device="cpu")
    xj = dhqr_tpu.lstsq_diff(jnp.asarray(A), jnp.asarray(b), *args)
    assert _rel(to_numpy(x), np.asarray(xj)) <= 1e-5
    assert blocked.panel_plan(48, 12, 8, True, torch.float32, "cpu",
                              flat=4) == [(0, 8, 4), (8, 4, 4)]


def test_lstsq_diff_routes_and_alias():
    A, b = random_problem(40, 10, np.float32, seed=93)
    base = dt.lstsq_diff(A, b, 4, device="cpu")  # "auto": plain on the CPU
    for kw in ({"pallas": False}, {"use_pallas": "never"},
               {"pallas": False, "use_pallas": "never"}):
        assert torch.equal(dt.lstsq_diff(A, b, 4, device="cpu", **kw), base)
    kern = dt.lstsq_diff(A, b, 4, pallas=True, device="cpu")
    assert torch.equal(kern, dt.lstsq_diff(A, b, 4, use_pallas="always",
                                           device="cpu"))
    assert torch.equal(kern, dt.lstsq_diff(A, b, 4, pallas=True,
                                           pallas_interpret=True,
                                           device="cpu"))
    with pytest.raises(ValueError, match="disagree"):
        dt.lstsq_diff(A, b, 4, pallas=True, use_pallas="never", device="cpu")
    with pytest.raises(ValueError, match="pallas must be"):
        dt.lstsq_diff(A, b, 4, pallas="always", device="cpu")
    with pytest.raises(ValueError, match="pallas_flat"):
        dt.lstsq_diff(A, b, 4, pallas=True, pallas_flat=0, device="cpu")


# -------------------------------------------------- QRFactorization (item 3)


def test_qr_factorization_fields_in_the_reference_order():
    mine = [f.name for f in dataclasses.fields(dt.QRFactorization)]
    theirs = [f.name for f in dataclasses.fields(dhqr_tpu.QRFactorization)]
    assert mine == theirs
    A, _ = random_problem(12, 4, np.float64, seed=94)
    f = dt.qr(A, device="cpu")
    fj = dhqr_tpu.qr(jnp.asarray(A))
    mine = dt.QRFactorization(f.H, f.alpha, 2, None, "highest")
    theirs = dhqr_tpu.QRFactorization(fj.H, fj.alpha, 2, None, "highest")
    for name in ("block_size", "mesh", "precision", "layout", "refine",
                 "comms"):
        assert getattr(mine, name) == getattr(theirs, name), name
    assert mine.precision == "highest" and mine.mesh is None
    assert mine.matrix is None and theirs.matrix is None


def test_qr_factorization_comms_waits_for_the_compressed_wire():
    """With the compressed wire ported, a factorization records its
    wire format, as the JAX package's does, and a one-device solve (no
    collective to compress) is the plain one."""
    f = dt.qr(np.eye(6, 3), device="cpu")
    fj = dhqr_tpu.qr(jnp.asarray(np.eye(6, 3)))
    for comms in ("bf16", "int8", "dcn:bf16"):
        mine = dt.QRFactorization(f.H, f.alpha, comms=comms)
        theirs = dhqr_tpu.QRFactorization(fj.H, fj.alpha, comms=comms)
        assert mine.comms == theirs.comms == comms
        rhs = np.arange(6.0)
        np.testing.assert_array_equal(mine.solve(rhs).numpy(),
                                      f.solve(rhs).numpy())


# ------------------------------------------------------- run_ranks device


def test_run_ranks_defaults_to_the_card(monkeypatch):
    assert inspect.signature(_ranks.run_ranks).parameters["device"].default \
        is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _ranks.run_ranks(_ranks.run_calls, 2, cases=[])


# --------------------------------- public methods of exported classes (item 5)


def _exported_classes():
    """(path, JAX class, port class) for every class in the ``__all__`` of
    the top level and of each sub-package both packages share."""
    import importlib

    out, seen = [], set()
    for sub in ("", ".ops", ".parallel", ".serve", ".solvers", ".utils",
                ".obs", ".tune", ".armor", ".numeric", ".faults",
                ".models"):
        theirs = importlib.import_module("dhqr_tpu" + sub)
        mine = importlib.import_module("dhqr_tpu_torch" + sub)
        for name in getattr(theirs, "__all__", ()):
            cls = getattr(theirs, name)
            if inspect.isclass(cls) and cls not in seen \
                    and hasattr(mine, name):
                seen.add(cls)
                out.append((f"dhqr_tpu{sub}.{name}", cls, getattr(mine, name)))
    return out


_CLASSES = _exported_classes()

# What the port's classes leave out of the JAX package's, each with why.
_METHODS_NOT_TWINNED = {
    # jax pytree hooks: a tensor dataclass is no pytree
    ("dhqr_tpu.QRFactorization", "tree_flatten"),
    ("dhqr_tpu.QRFactorization", "tree_unflatten"),
}
def _params(fn):
    return [(p.name, p.kind) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("path,theirs,mine", _CLASSES,
                         ids=[c[0] for c in _CLASSES])
def test_public_methods_take_the_reference_parameters(path, theirs, mine):
    """Every public method (and ``__init__``) of an exported class takes the
    JAX package's parameters, in order and kind; the one allowed addition
    is a ``device`` parameter after them (before a ``**kwargs``)."""
    for attr, value in vars(theirs).items():
        if attr.startswith("_") and attr != "__init__":
            continue
        if not (callable(value) or isinstance(value, (staticmethod,
                                                      classmethod))):
            continue
        if (path, attr) in _METHODS_NOT_TWINNED:
            continue
        assert inspect.getattr_static(mine, attr, None) is not None, \
            f"{path}.{attr} has no twin"
        try:
            ref = _params(getattr(theirs, attr))
        except (TypeError, ValueError):
            continue  # a builtin slot with no signature
        got = _params(getattr(mine, attr))
        if got == ref:
            continue
        var_kw = [p for p in ref if p[1] is inspect.Parameter.VAR_KEYWORD]
        head = [p for p in ref if p not in var_kw]
        assert got[:len(head)] == head and [p[0] for p in got[len(head):]] \
            == ["device"] + [p[0] for p in var_kw], \
            f"{path}.{attr}: {got} is not the reference's {ref} (+ device)"


def test_executable_store_takes_the_reference_clock_and_save_keyword(
        tmp_path):
    """Queue C item 5: ``ExecutableStore(root, clock=)`` and
    ``save(key, compiled=)``, as in the JAX package."""
    from dhqr_tpu_torch.serve.cache import CacheKey
    from dhqr_tpu_torch.serve.store import ExecutableStore

    ticks = iter(range(100))
    store = ExecutableStore(str(tmp_path), clock=lambda: next(ticks))
    assert store._clock() == 0
    key = CacheKey("lstsq", 4, 64, 16, "float32", 8, "highest", None,
                   None, 0, "accurate", "loop")
    assert store.save(key, compiled=object()) is None
    assert store.stats()["puts"] == 1
    record, reason = store.read_record(key)
    assert reason is None and record["program"] == "object"
