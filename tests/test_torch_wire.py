"""PyTorch port: the compressed wire (``dhqr_tpu_torch.parallel.wire``) —
the int8 quantizer and the bf16 round trip bit for bit against the JAX
seam's, the census's byte ratios, the wire formats through the four mesh
engines and the model tier, and the collective fault sites, on gloo
process groups of 2 and 4 CPU ranks against the JAX package on the
conftest's 8-device CPU mesh.

One spawn per rank count for the module (``parallel/_ranks.run_ranks``
with ``run_calls``); inputs are made with numpy from a seed. Tolerances,
float64, relative to the largest entry: a compressed call within 2^-6
(bf16) or 4/127 (int8) of the JAX package's same call — one or two of the
wire's rounding steps, where a value at a rounding boundary may round
apart in the two packages; fault schedules within 1e-9; every float32 x
of a compressed model-tier solve under the reference's 8x criterion.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
from dhqr_tpu import faults as jfaults  # noqa: E402
from dhqr_tpu.parallel import column_mesh, row_mesh  # noqa: E402
from dhqr_tpu.parallel import sharded_qr as jsq  # noqa: E402
from dhqr_tpu.parallel import wire as jwire  # noqa: E402
from dhqr_tpu.parallel.sharded_cholqr import sharded_cholqr_lstsq  # noqa: E402,E501
from dhqr_tpu.parallel.sharded_solve import sharded_lstsq  # noqa: E402
from dhqr_tpu.parallel.sharded_tsqr import sharded_tsqr_lstsq  # noqa: E402
from dhqr_tpu.utils.config import FaultConfig as JFaultConfig  # noqa: E402
from dhqr_tpu.utils.testing import (  # noqa: E402
    TOLERANCE_FACTOR,
    normal_equations_residual,
    oracle_residual,
    random_problem,
)
from dhqr_tpu_torch import precision as tprecision  # noqa: E402
from dhqr_tpu_torch.obs import netmodel as tnet  # noqa: E402
from dhqr_tpu_torch.parallel import wire  # noqa: E402
from dhqr_tpu_torch.parallel._ranks import (  # noqa: E402
    COLS,
    ROWS,
    AsTensor,
    results_equal_across_ranks,
    run_calls,
    run_ranks,
)
from dhqr_tpu_torch.utils.config import DHQRConfig, FaultConfig  # noqa: E402

RANKS = (2, 4)
NB = 4
TOL = {"bf16": 2.0 ** -6, "int8": 4 / 127}
A, b = random_problem(32, 24, np.float64, seed=71)
TALL, TALL_B = random_problem(64, 8, np.float64, seed=72)
_rng = np.random.default_rng(73)
PANEL = _rng.standard_normal((64, 16)).astype(np.float32)
PANEL_C = (_rng.standard_normal((64, 16))
           + 1j * _rng.standard_normal((64, 16))).astype(np.complex64)
A48 = _rng.random((48, 16)).astype(np.float32)
B48 = _rng.random(48).astype(np.float32)
T128 = _rng.random((128, 8)).astype(np.float32)
B128 = _rng.random(128).astype(np.float32)
A64 = _rng.standard_normal((64, 32)).astype(np.float32)
COMPRESSED = ("bf16", "int8")
ENGINE_COMMS = (None, "bf16", "int8")
FAULTS = (("parallel.collective.drop", 3), ("parallel.collective.corrupt", 3),
          ("parallel.collective.corrupt", 2))


def _cases():
    cases = {}
    for c in ENGINE_COMMS:
        cases[f"qr_{c}"] = [("sharded_blocked_qr", (A, COLS),
                             dict(block_size=NB, comms=c))]
        cases[f"lstsq_{c}"] = [("sharded_lstsq", (A, b, COLS),
                                dict(block_size=NB, comms=c))]
        cases[f"tsqr_{c}"] = [("sharded_tsqr_lstsq", (TALL, TALL_B, ROWS),
                               dict(block_size=NB, comms=c))]
        cases[f"cholqr_{c}"] = [("sharded_cholqr_lstsq",
                                 (TALL, TALL_B, ROWS), dict(comms=c))]
        cases[f"backward_{c}"] = [("sharded_blocked_qr", (A64, COLS),
                                   dict(block_size=8, comms=c))]
    for spelling, kw in (("none", {"comms": "none"}),
                         ("f32", {"comms": "f32"}),
                         ("accurate", {"policy": "accurate"}),
                         ("dcn_1d", {"comms": "dcn:bf16"})):
        cases[f"qr_spelling_{spelling}"] = [("sharded_blocked_qr", (A, COLS),
                                             dict(block_size=NB, **kw))]
    for c in COMPRESSED:
        cases[f"model_{c}"] = [("lstsq", (A48, B48), dict(
            mesh=COLS, block_size=NB, comms=c))]
        cases[f"model_factor_{c}"] = [
            ("qr", (A48,), dict(mesh=COLS, block_size=NB, comms=c,
                                policy=None)), (".solve", (B48,), {})]
        for engine in ("tsqr", "cholqr2"):
            cases[f"model_{engine}_{c}"] = [("lstsq", (T128, B128), dict(
                mesh=ROWS, engine=engine, block_size=8, comms=c))]
        cases[f"policy_spec_{c}"] = [("sharded_blocked_qr", (A, COLS),
                                      dict(block_size=NB,
                                           policy=f"highest/{c}"))]
    for site, k in FAULTS:
        cases[f"fault_{site}_{k}"] = {
            "steps": [("sharded_blocked_qr", (A, COLS), dict(block_size=NB))],
            "faults": FaultConfig(sites=((site, 1.0, 1, k),))}
    for c in ENGINE_COMMS:
        cases[f"census_{c}"] = {
            "steps": [("parallel.wire.wire_broadcast",
                       (AsTensor(PANEL), 0, COLS), dict(comms=c))],
            "census": True}
    cases["census_complex_int8"] = {
        "steps": [("parallel.wire.wire_broadcast",
                   (AsTensor(PANEL_C), 0, COLS), dict(comms="int8"))],
        "census": True}
    cases["census_complex_None"] = {
        "steps": [("parallel.wire.wire_broadcast",
                   (AsTensor(PANEL_C), 0, COLS), {})], "census": True}
    cases["census_dense_int8"] = {
        "steps": [("parallel.wire.wire_psum", (AsTensor(PANEL), COLS),
                   dict(comms="int8", onehot=False))], "census": True}
    cases["census_dense_None"] = {
        "steps": [("parallel.wire.wire_psum", (AsTensor(PANEL), COLS),
                   dict(onehot=False))], "census": True}
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def ranks():
    """``ranks(P)``: {case: rank 0's outcome} from one spawn of P ranks;
    every rank's values are bit-identical (checked here)."""
    runs = {}

    def get(P):
        if P not in runs:
            per_rank = run_ranks(run_calls, P, device="cpu", timeout_s=240,
                                 cases=list(CASES.values()))
            assert results_equal_across_ranks(
                [[o[:2] for o in r] for r in per_rank])
            runs[P] = dict(zip(CASES, per_rank[0]))
        return runs[P]

    return get


def _ok(outcome):
    assert outcome[0] == "ok", outcome
    return outcome[1]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -------------------------------------------------------- the quantizer

def _payloads():
    rng = np.random.default_rng(74)
    out = {}
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        x = (rng.standard_normal((70, 5))
             * np.logspace(-3, 3, 5)).astype(dt)
        x[:32, 1] = 0.0            # a zero block
        x[40, 2] = np.nan          # a NaN block
        x[64, 3] = np.inf          # an inf block (ragged: 6 rows)
        out[f"blocks_{name}"] = x
        out[f"short_{name}"] = rng.standard_normal((7, 3)).astype(dt)
        out[f"one_row_{name}"] = np.array([[0.0, 3.0, -2.0]], dt)
        out[f"vector_{name}"] = rng.standard_normal(9).astype(dt)
        v = rng.standard_normal(9).astype(dt)
        v[3] = np.nan
        out[f"vector_nan_{name}"] = v
        out[f"zeros_{name}"] = np.zeros((33, 2), dt)
        out[f"ties_{name}"] = (np.arange(1, 200) * (1 + 2.0 ** -8)).astype(dt)
        out[f"halves_{name}"] = (np.arange(-300, 300) / 2.0
                                 * (127 / 150)).astype(dt)
    return out


PAYLOADS = _payloads()


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_quantizer_and_bf16_round_trip_match_jax_bit_for_bit(name):
    x = PAYLOADS[name]
    qj, sj = jwire._quant_int8(jnp.asarray(x))
    qt, st = wire._quant_int8(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and tuple(st.shape) == tuple(sj.shape)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    back_j = np.asarray(jwire._dequant_int8(qj, sj, jnp.asarray(x).dtype))
    back_t = wire._dequant_int8(qt, st, torch.from_numpy(x).dtype).numpy()
    np.testing.assert_array_equal(back_t, back_j)
    bf_j = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(x.dtype))
    bf_t = torch.from_numpy(x).to(torch.bfloat16).to(
        torch.from_numpy(x).dtype).numpy()
    np.testing.assert_array_equal(bf_t, bf_j)


def test_wire_constants_and_vocabulary_match_jax():
    assert wire.INT8_BLOCK_ROWS == jwire.INT8_BLOCK_ROWS
    assert wire.CSNE_SWEEPS == jwire.CSNE_SWEEPS
    assert wire.CSNE_MODEL_SWEEPS == jwire.CSNE_MODEL_SWEEPS
    assert wire._DCN_TIERED == jwire._DCN_TIERED
    assert wire.COMMS_MODES == jwire.COMMS_MODES
    assert wire.WIRE_ITEMSIZE == jwire.WIRE_ITEMSIZE == tnet.WIRE_ITEMSIZE
    for comms in (None,) + wire.COMMS_MODES:
        assert wire._leg_comms(comms) == jwire._leg_comms(comms)


def test_wire_modes_validation_and_model_normalization():
    """``test_wire.py``'s validation cases on the port: the spellings, a
    typo refused at the model tier too, "f32" collapsing to None."""
    from dhqr_tpu_torch.models.qr_model import _resolve_policy_cfg

    assert wire.resolve_comms(None) is None
    assert wire.resolve_comms("none") is None
    assert wire.resolve_comms("f32") is None
    assert wire.resolve_comms("bf16") == "bf16"
    with pytest.raises(ValueError, match="comms must be one of"):
        wire.resolve_comms("fp8")
    with pytest.raises(ValueError, match="comms must be one of"):
        _resolve_policy_cfg(DHQRConfig(comms="fp8"))
    cfg, _ = _resolve_policy_cfg(DHQRConfig(comms="f32"))
    assert cfg.comms is None


def test_policy_comms_segment_matches_jax():
    from dhqr_tpu.precision import resolve_policy as jresolve

    for spec in ("highest/default/r1/bf16", "highest/bf16",
                 "highest/high/int8", "highest/dcn:bf16", "accurate",
                 "balanced", "fast"):
        mine, theirs = tprecision.resolve_policy(spec), jresolve(spec)
        assert (mine.panel, mine.trailing, mine.refine, mine.comms) == (
            theirs.panel, theirs.trailing, theirs.refine, theirs.comms)
    with pytest.raises(ValueError, match="comms must be one of"):
        tprecision.PrecisionPolicy(comms="fp8")


# ----------------------------------------------------------- the census

def _census(outcome):
    assert outcome[0] == "ok", outcome
    return outcome[2]


@pytest.mark.parametrize("P", RANKS)
def test_census_ratios_of_one_collective(ranks, P):
    """64 x 16 f32 panel: bf16 carries half the bytes, int8 (1 + 4/32)/4
    (a 4-byte scale per 32-row block of each column), a complex payload
    all of them, and a dense int8 sum bf16's half."""
    got = ranks(P)

    def nbytes(name):
        (entry,) = _census(got[name])
        return entry["bytes"], entry

    base, e0 = nbytes("census_None")
    assert base == PANEL.nbytes and e0["family"] == "broadcast"
    assert e0["leg"] == "flat" and e0["launches"] == 1
    assert nbytes("census_bf16")[0] / base == 0.5
    assert nbytes("census_int8")[0] / base == (1 + 4 / 32) / 4
    assert nbytes("census_complex_int8")[0] / \
        nbytes("census_complex_None")[0] == 1.0
    dense, e = nbytes("census_dense_int8")
    assert dense / nbytes("census_dense_None")[0] == 0.5
    assert e["family"] == "psum" and e["wire"] == "bfloat16"
    # what arrived: the sender's rounding on every rank (checked equal
    # across ranks by the fixture), the JAX seam's round trip
    jp = jnp.asarray(PANEL)
    np.testing.assert_array_equal(
        _ok(got["census_bf16"]),
        np.asarray(jp.astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(
        _ok(got["census_int8"]),
        np.asarray(jwire._dequant_int8(*jwire._quant_int8(jp),
                                       jnp.float32)))
    np.testing.assert_array_equal(_ok(got["census_complex_int8"]), PANEL_C)


# ---------------------------------------------------------- the engines

@pytest.mark.parametrize("P", RANKS)
def test_uncompressed_spellings_are_bit_identical(ranks, P):
    """None, "none", "f32", the accurate policy and a dcn:* format on a
    1-D axis all run the uncompressed tier, bit for bit."""
    got = ranks(P)
    H0, a0 = _ok(got["qr_None"])
    for name in ("none", "f32", "accurate", "dcn_1d"):
        H, a = _ok(got[f"qr_spelling_{name}"])
        np.testing.assert_array_equal(H, H0)
        np.testing.assert_array_equal(a, a0)


def _jax_call(kind, comms, P):
    if kind == "qr":
        return jsq.sharded_blocked_qr(jnp.asarray(A), column_mesh(P),
                                      block_size=NB, comms=comms)
    if kind == "lstsq":
        return sharded_lstsq(jnp.asarray(A), jnp.asarray(b), column_mesh(P),
                             block_size=NB, comms=comms)
    if kind == "tsqr":
        return sharded_tsqr_lstsq(jnp.asarray(TALL), jnp.asarray(TALL_B),
                                  row_mesh(P), block_size=NB, comms=comms)
    return sharded_cholqr_lstsq(jnp.asarray(TALL), jnp.asarray(TALL_B),
                                row_mesh(P), comms=comms)


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("comms", COMPRESSED)
@pytest.mark.parametrize("kind", ["qr", "lstsq", "tsqr", "cholqr"])
def test_compressed_engines_match_jax(ranks, P, comms, kind):
    got = _ok(ranks(P)[f"{kind}_{comms}"])
    want = _jax_call(kind, comms, P)
    if kind == "qr":
        for g, w in zip(got, want):
            assert _rel(g, w) <= TOL[comms], (kind, comms)
    else:
        assert _rel(got, want) <= TOL[comms], (kind, comms)
        x_none = _ok(ranks(P)[f"{kind}_None"])
        assert not np.array_equal(got, x_none)  # the wire really rounded


def _backward(H, alpha, A_):
    """||QR - A|| / ||A|| in float64 of packed (H, alpha)."""
    H, A_ = np.asarray(H, np.float64), np.asarray(A_, np.float64)
    m, n = H.shape
    QR = np.zeros((m, n))
    QR[:n] = np.triu(H[:n], 1) + np.diag(np.asarray(alpha, np.float64))
    for j in reversed(range(n)):
        v = np.zeros(m)
        v[j:] = H[j:, j]
        QR -= np.outer(v, v @ QR)
    return float(np.linalg.norm(QR - A_) / np.linalg.norm(A_))


@pytest.mark.parametrize("P", RANKS)
def test_bf16_backward_error_is_bounded_and_real(ranks, P):
    errs = {c: _backward(*_ok(ranks(P)[f"backward_{c}"]), A64)
            for c in (None, "bf16", "int8")}
    assert errs[None] < 1e-5
    for c in COMPRESSED:
        assert errs[None] < errs[c] < 0.05, errs


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("comms", COMPRESSED)
def test_compressed_mesh_lstsq_holds_8x_by_contract(ranks, P, comms):
    """The model tier floors a compressed column-mesh solve at
    ``CSNE_MODEL_SWEEPS`` sweeps; the row engines sweep inside."""
    got = ranks(P)
    x = _ok(got[f"model_{comms}"])
    assert normal_equations_residual(A48, x, B48) < \
        TOLERANCE_FACTOR * oracle_residual(A48, B48)
    for engine in ("tsqr", "cholqr2"):
        xt = _ok(got[f"model_{engine}_{comms}"])
        assert normal_equations_residual(T128, xt, B128) < \
            TOLERANCE_FACTOR * oracle_residual(T128, B128), engine
    # the factorization records the wire; its solve rides it (no sweep:
    # the factorization was made without a refining policy)
    x_fact = _ok(got[f"model_factor_{comms}"])
    assert np.all(np.isfinite(x_fact))
    x_j = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A48), jnp.asarray(B48),
                                    mesh=column_mesh(P), block_size=NB,
                                    comms=comms))
    assert _rel(x, x_j) <= 1e-4


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("comms", COMPRESSED)
def test_policy_comms_segment_runs_the_wire(ranks, P, comms):
    got = ranks(P)
    for g, w in zip(_ok(got[f"policy_spec_{comms}"]),
                    _ok(got[f"qr_{comms}"])):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("site,k", FAULTS)
def test_collective_fault_sites_match_jax(ranks, P, site, k):
    """On the unrolled shape, a fault on the k-th collective (the JAX
    engine's pf and alpha sums of panel (k - 1) // 2) lands where JAX's
    does: the zero contributors' hits included."""
    got = _ok(ranks(P)[f"fault_{site}_{k}"])
    with jfaults.injected(JFaultConfig(sites=((site, 1.0, 1, k),))):
        want = jsq.sharded_blocked_qr(jnp.asarray(A), column_mesh(P),
                                      block_size=NB)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-9, site
    clean = _ok(ranks(P)["qr_None"])
    assert not all(np.array_equal(g, c)  # the fault landed (H or alpha)
                   for g, c in zip(got, clean))
