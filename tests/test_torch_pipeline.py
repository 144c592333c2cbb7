"""PyTorch port: the depth-k pipeline of the column-sharded engine
(``sharded_blocked_qr(..., lookahead=True, overlap_depth=k)``), depths 2
and 3 on gloo groups of 2 and 4 CPU ranks, block and cyclic layouts, at
32 x 24 (the JAX engine's unrolled panel loop) and 72 x 72 (its scanned
one).

Held three ways, float64, relative to the largest entry: to the JAX
package's pipeline at the same depth within 1e-9 (its own
``test_sharded_pipeline_bitwise_equals_lookahead`` does not hold bit for
bit on this tree, so roundoff is the bar); to the port's lookahead order
within 1e-12 (the same arithmetic per column, GEMMs blocked otherwise);
and its ``lstsq`` to LAPACK under the reference's 8x criterion. A bf16
pipeline is held to the JAX package's within 2^-6. One spawn per rank
count for the module; inputs from a seed with numpy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu.parallel import column_mesh  # noqa: E402
from dhqr_tpu.parallel import sharded_qr as jsq  # noqa: E402
from dhqr_tpu.utils.testing import (  # noqa: E402
    TOLERANCE_FACTOR,
    normal_equations_residual,
    oracle_residual,
    random_problem,
)
from dhqr_tpu_torch.parallel._ranks import (  # noqa: E402
    COLS,
    results_equal_across_ranks,
    run_calls,
    run_ranks,
)

RANKS = (2, 4)
DEPTHS = (2, 3)
LAYOUTS = ("block", "cyclic")
NB = 4
PROBLEMS = {"U": random_problem(32, 24, np.float64, seed=81),
            "S": random_problem(72, 72, np.float64, seed=82)}


def _cases():
    cases = {}
    for shape, (A, b) in PROBLEMS.items():
        for layout in LAYOUTS:
            kw = dict(block_size=NB, layout=layout, lookahead=True)
            cases[f"la_{shape}_{layout}"] = [
                ("sharded_blocked_qr", (A, COLS), kw)]
            for d in DEPTHS:
                cases[f"pipe{d}_{shape}_{layout}"] = [
                    ("sharded_blocked_qr", (A, COLS),
                     dict(kw, overlap_depth=d))]
                cases[f"lstsq{d}_{shape}_{layout}"] = [
                    ("lstsq", (A, b), dict(kw, mesh=COLS, overlap_depth=d))]
    A, _ = PROBLEMS["U"]
    cases["pipe2_bf16"] = [("sharded_blocked_qr", (A, COLS), dict(
        block_size=NB, lookahead=True, overlap_depth=2, comms="bf16"))]
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def ranks():
    runs = {}

    def get(P):
        if P not in runs:
            per_rank = run_ranks(run_calls, P, device="cpu", timeout_s=240,
                                 cases=list(CASES.values()))
            assert results_equal_across_ranks(per_rank)
            runs[P] = dict(zip(CASES, per_rank[0]))
        return runs[P]

    return get


def _ok(outcome):
    assert outcome[0] == "ok", outcome
    return outcome[1]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", sorted(PROBLEMS))
def test_pipeline_matches_jax_lookahead_and_lapack(ranks, P, depth, layout,
                                                   shape):
    A, b = PROBLEMS[shape]
    got = ranks(P)
    H, alpha = _ok(got[f"pipe{depth}_{shape}_{layout}"])
    H_j, alpha_j = jsq.sharded_blocked_qr(
        jnp.asarray(A), column_mesh(P), block_size=NB, layout=layout,
        lookahead=True, overlap_depth=depth)
    assert _rel(H, H_j) <= 1e-9 and _rel(alpha, alpha_j) <= 1e-9
    H_la, alpha_la = _ok(got[f"la_{shape}_{layout}"])
    assert _rel(H, H_la) <= 1e-12 and _rel(alpha, alpha_la) <= 1e-12
    x = _ok(got[f"lstsq{depth}_{shape}_{layout}"])
    assert normal_equations_residual(A, x, b) <= \
        TOLERANCE_FACTOR * oracle_residual(A, b)


@pytest.mark.parametrize("P", RANKS)
def test_bf16_pipeline_matches_jax(ranks, P):
    A, _ = PROBLEMS["U"]
    H, alpha = _ok(ranks(P)["pipe2_bf16"])
    H_j, alpha_j = jsq.sharded_blocked_qr(
        jnp.asarray(A), column_mesh(P), block_size=NB, lookahead=True,
        overlap_depth=2, comms="bf16")
    assert _rel(H, H_j) <= 2.0 ** -6 and _rel(alpha, alpha_j) <= 2.0 ** -6
    H_plain, _ = _ok(ranks(P)["pipe2_U_block"])
    assert not np.array_equal(H, H_plain)  # the wire really rounded
