"""PyTorch port: the ``dhqr.*`` spans of the single-device main path.

Under ``torch.profiler`` the entry points, the blocked engine, each panel
step, each trailing update, Q^H b and back-substitution carry their
names (``utils.profiling.phase``), nested as the calls nest; with no
profiler running the path enters no ``record_function`` at all, and the
outputs are bit for bit the same either way. CPU only, small shapes.
"""

import pytest

torch = pytest.importorskip("torch")

import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu_torch.analysis import oplog  # noqa: E402
from dhqr_tpu_torch.utils import profiling  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

M, N, NB = 1024, 256, 128
# three panels, for the schedules and the checks that run the path often
SM, SNB = 192, 16


def _problem(m=M, n=N, dtype=torch.float64):
    g = torch.Generator().manual_seed(19)
    return (torch.randn(m, n, generator=g, dtype=dtype),
            torch.randn(m, generator=g, dtype=dtype))


def _spans(run):
    """Run ``run()`` under the CPU profiler; returns its result and the
    ``dhqr.*`` spans as ``[(name, parent name or None), ...]`` in start
    order (the parent: the innermost ``dhqr.*`` span holding it)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    spans = sorted(((e.start_ns(), -e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("dhqr.")))
    tree, stack = [], []
    for start, neg_end, name in spans:
        while stack and stack[-1][0] < -neg_end:
            stack.pop()
        tree.append((name, stack[-1][1] if stack else None))
        stack.append((-neg_end, name))
    return out, tree


def _count(tree, name, parent="*"):
    return sum(1 for n, p in tree if n == name and parent in ("*", p))


def test_qr_then_solve_nest():
    A, b = _problem()

    def run():
        return dt.qr(A, block_size=NB, device="cpu").solve(b)

    _, tree = _spans(run)
    assert _count(tree, "dhqr.qr") == 1
    assert _count(tree, "dhqr.factor", "dhqr.qr") == 1
    assert _count(tree, "dhqr.panel", "dhqr.factor") == 2
    assert _count(tree, "dhqr.trailing", "dhqr.factor") == 1
    assert _count(tree, "dhqr.solve") == 1
    assert _count(tree, "dhqr.apply_qt", "dhqr.solve") == 1
    assert _count(tree, "dhqr.back_substitute", "dhqr.solve") == 1
    assert len(tree) == 8
    assert tree[0] == ("dhqr.qr", None)


def test_lstsq_nests_the_same():
    A, b = _problem()
    _, tree = _spans(lambda: dt.lstsq(A, b, block_size=NB, device="cpu"))
    assert tree[0] == ("dhqr.lstsq", None)
    assert _count(tree, "dhqr.lstsq") == 1
    assert _count(tree, "dhqr.factor", "dhqr.lstsq") == 1
    assert _count(tree, "dhqr.panel", "dhqr.factor") == 2
    assert _count(tree, "dhqr.trailing", "dhqr.factor") == 1
    assert _count(tree, "dhqr.apply_qt", "dhqr.lstsq") == 1
    assert _count(tree, "dhqr.back_substitute", "dhqr.lstsq") == 1
    assert len(tree) == 7


SCHEDULES = [
    ({"lookahead": True}, torch.float64),
    ({"agg_panels": 2}, torch.float64),
    ({"use_pallas": "always"}, torch.float32),
]


@pytest.mark.parametrize("opts,dtype", SCHEDULES,
                         ids=["lookahead", "agg_panels", "kernel_plain"])
def test_one_panel_span_per_panel(opts, dtype):
    A, _ = _problem(SM, 3 * SNB, dtype)
    _, tree = _spans(lambda: dt.qr(A, block_size=SNB, device="cpu", **opts))
    assert _count(tree, "dhqr.panel", "dhqr.factor") == 3
    assert _count(tree, "dhqr.panel") == 3
    # the recursion's reflector applies inside a panel are panel work
    assert _count(tree, "dhqr.trailing", "dhqr.panel") == 0
    assert _count(tree, "dhqr.trailing", "dhqr.factor") >= 2


def test_no_record_function_with_the_profiler_off(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    A, b = _problem(SM, 3 * SNB)
    dt.qr(A, block_size=SNB, device="cpu").solve(b)
    dt.lstsq(A, b, block_size=SNB, device="cpu")
    dt.qr(A, block_size=SNB, device="cpu", lookahead=True)
    dt.qr(A, block_size=SNB, device="cpu", agg_panels=2)
    dt.qr(A.float(), block_size=SNB, device="cpu", use_pallas="always")
    assert profiling.phase("a") is profiling.phase("b")


def test_outputs_bitwise_with_the_profiler_on_and_off():
    A, b = _problem(SM, 3 * SNB)

    def run():
        fact = dt.qr(A, block_size=SNB, device="cpu")
        return (fact.H, fact.alpha, fact.solve(b),
                dt.lstsq(A, b, block_size=SNB, device="cpu"),
                dt.qr(A.float(), block_size=SNB, device="cpu",
                      use_pallas="always", lookahead=True).H,
                dt.qr(A, block_size=SNB, device="cpu", agg_panels=2).H)

    off = run()
    on, tree = _spans(run)
    assert tree
    for x, y in zip(off, on):
        assert torch.equal(x, y)


def test_spans_add_no_op_to_the_op_log():
    A, b = _problem(SM, 3 * SNB)

    def logged():
        with oplog.record() as log:
            dt.qr(A, block_size=SNB, device="cpu").solve(b)
        return log.signature()

    off = logged()
    assert off
    assert not [s for s in off if "profiler" in str(s)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = logged()
    assert any(e.name().startswith("dhqr.")
               for e in prof.profiler.kineto_results.events())
    assert on == off
