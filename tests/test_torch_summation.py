"""PyTorch port: ops/summation.py against the JAX package's.

The port keeps the JAX tree's halving order (odd-length zero pad
included), so the same input should give the same sum bit for bit; the
assertion is <= 1 ulp of the JAX result, which is what the accuracy
contract promises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu.ops import summation as jsum  # noqa: E402
from dhqr_tpu_torch.ops import summation as tsum  # noqa: E402

LENGTHS = [1, 2, 7, 33, 1000, 1023, 4097]


def _within_ulp(got, want, ulps=1):
    got, want = np.asarray(got), np.asarray(want)
    assert abs(got - want) <= ulps * np.spacing(np.abs(want).astype(want.dtype)), \
        (got, want)


def _vector(n, dtype, seed):
    rng = np.random.default_rng(seed)
    # mixed signs and a spread of magnitudes: the compensation has work to do
    return (rng.standard_normal(n) * np.logspace(-3, 3, n)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", LENGTHS)
def test_tree_sum_matches_jax(n, dtype):
    x = _vector(n, dtype, seed=n)
    got = tsum.tree_sum(torch.from_numpy(x)).numpy()
    _within_ulp(got, np.asarray(jsum.tree_sum(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [7, 1023, 4097])
def test_sumsq_accurate_matches_jax(n, dtype):
    x = _vector(n, dtype, seed=2 * n)
    got = tsum.sumsq(torch.from_numpy(x), "accurate").numpy()
    _within_ulp(got, np.asarray(jsum.sumsq(jnp.asarray(x), "accurate")))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [7, 1023, 4097])
def test_accurate_vdot_matches_jax(n, dtype):
    a, b = _vector(n, dtype, seed=n + 1), _vector(n, dtype, seed=n + 2)
    got = tsum.accurate_vdot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    _within_ulp(got, np.asarray(jsum.accurate_vdot(jnp.asarray(a),
                                                   jnp.asarray(b))))


def test_complex_sumsq_and_norm_match_jax():
    """Complex input: |x|^2 from the two planes, then the same tree. The
    squares are formed by the same ops, so <= 1 ulp holds here too."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(513) + 1j * rng.standard_normal(513))
    for dtype in (np.complex64, np.complex128):
        xc = x.astype(dtype)
        got = tsum.sumsq(torch.from_numpy(xc)).numpy()
        _within_ulp(got, np.asarray(jsum.sumsq(jnp.asarray(xc))))
        got = tsum.norm2(torch.from_numpy(xc)).numpy()
        _within_ulp(got, np.asarray(jsum.norm2(jnp.asarray(xc))))


def test_fast_mode_and_bad_mode():
    """"fast" is a plain reduce (another order than XLA's): within a few
    ulps of f64 for a sum of squares, which cannot cancel."""
    x = _vector(1000, np.float32, seed=9)
    got = float(tsum.sumsq(torch.from_numpy(x), "fast"))
    want = float(np.sum(x.astype(np.float64) ** 2))
    assert abs(got - want) / want < 1e-6
    with pytest.raises(ValueError):
        tsum.sumsq(torch.from_numpy(x), "bogus")


def test_empty_sum_is_zero():
    assert float(tsum.tree_sum(torch.zeros(0))) == 0.0
