"""PyTorch port: dhqr-lint's source passes over ``dhqr_tpu_torch``.

Three parts:

* **Parity.** The rules that carry over unchanged (DHQR003's JAX part,
  DHQR006, DHQR008) and the suppression grammar scan the JAX package's
  fixtures (``tests/fixtures/analysis/dhqrNNN_{bad,good}.py``, read only)
  with both packages' ``scan_source``, each at the same virtual path in
  its own tree: the (rule, line, suppressed) lists are identical. The
  baseline file round-trips between the packages.
* **The torch forms.** DHQR001-005, 007, 009 and 010 check PyTorch
  constructs; each has a bad/good pair as an inline source string
  (never a ``.py`` file under ``tests/``: the JAX self-scan reads every
  file there), held to its exact rule and lines.
* **The gate.** The port's tree, ``chip_smoke.py`` and
  ``tests/test_torch_*.py`` scan clean against the empty baseline, every
  suppression carries a reason, and the CLI keeps the JAX package's exit
  codes and JSON shape.
"""

import json
import os

import pytest

pytest.importorskip("torch")

from dhqr_tpu.analysis.ast_rules import scan_source as jscan  # noqa: E402
from dhqr_tpu.analysis.findings import (  # noqa: E402
    load_baseline as jload_baseline,
)

from dhqr_tpu_torch.analysis import ast_rules, cli  # noqa: E402
from dhqr_tpu_torch.analysis.ast_rules import (  # noqa: E402
    scan_paths,
    scan_source,
)
from dhqr_tpu_torch.analysis.findings import (  # noqa: E402
    load_baseline,
    prune_baseline,
    write_baseline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")
PKG = "dhqr_tpu_torch/ops/_fixture.py"
PAR = "dhqr_tpu_torch/parallel/_fixture.py"

pytestmark = pytest.mark.lint


def _fixture(name):
    with open(os.path.join(FIXTURES, name), "r", encoding="utf-8") as fh:
        return fh.read()


def _hits(findings, rule):
    return sorted(f.line for f in findings
                  if f.rule == rule and not f.suppressed)


def _rows(findings, rules):
    return [(f.rule, f.line, f.suppressed) for f in findings
            if f.rule in rules]


# -- parity with the JAX package on its fixtures ----------------------------

CARRIED = [("dhqr003_bad.py", "DHQR003"), ("dhqr003_good.py", "DHQR003"),
           ("dhqr006_bad.py", "DHQR006"), ("dhqr006_good.py", "DHQR006"),
           ("dhqr008_bad.py", "DHQR008"), ("dhqr008_good.py", "DHQR008")]


@pytest.mark.parametrize("sub", ["ops", "parallel", "serve"])
@pytest.mark.parametrize("name,rule", CARRIED)
def test_carried_rules_find_what_the_jax_rules_find(name, rule, sub):
    text = _fixture(name)
    theirs = jscan(text, f"dhqr_tpu/{sub}/_fixture.py")
    mine = scan_source(text, f"dhqr_tpu_torch/{sub}/_fixture.py")
    assert _rows(mine, {rule, "DHQR000"}) == _rows(theirs,
                                                   {rule, "DHQR000"})
    if name.endswith("_bad.py"):
        assert _hits(mine, rule), "every bad fixture exercises its rule"


@pytest.mark.parametrize("path", ["tests/test_fixture.py",
                                  "benchmarks/probe.py"])
@pytest.mark.parametrize("name", ["dhqr006_bad.py", "dhqr008_bad.py"])
def test_carried_rules_scope_matches_the_jax_rules(name, path):
    text = _fixture(name)
    assert _rows(scan_source(text, path), {"DHQR006", "DHQR008"}) == \
        _rows(jscan(text, path), {"DHQR006", "DHQR008"}) == []


def test_suppression_grammar_is_the_jax_grammar():
    text = _fixture("dhqr002_suppressed.py")
    mine = scan_source(text, PKG)
    theirs = jscan(text, "dhqr_tpu/ops/_fixture.py")
    assert [(f.rule, f.line, f.suppressed, f.reason) for f in mine] == \
        [(f.rule, f.line, f.suppressed, f.reason) for f in theirs]
    by_line = {f.line: f for f in mine if f.rule == "DHQR002"}
    assert by_line[7].suppressed and "oracle" in by_line[7].reason
    assert by_line[9].suppressed          # directive on the line above
    assert not by_line[10].suppressed     # ignore[DHQR004] names another rule


def test_missing_reason_is_a_warning_in_both_packages():
    # the directive is spelled in two pieces so that this file's own
    # scan does not read it as one
    src = ("import os\n"
           "os.environ['A'] = '1'  # dhqr: " + "ignore[DHQR003]\n")
    mine = scan_source(src, PKG)
    theirs = jscan(src, "dhqr_tpu/ops/_fixture.py")
    assert [(f.rule, f.line, f.suppressed, f.severity) for f in mine] == \
        [(f.rule, f.line, f.suppressed, f.severity) for f in theirs] == \
        [("DHQR003", 2, True, "error"), ("DHQR000", 2, False, "warning")]


def test_baseline_file_is_the_jax_format(tmp_path):
    findings = scan_source(_fixture("dhqr008_bad.py"), PKG)
    path = tmp_path / "baseline.json"
    write_baseline(path, findings)
    accepted = load_baseline(path)
    assert accepted == jload_baseline(path)
    assert sum(accepted.values()) == len(_hits(findings, "DHQR008")) == 3
    # a finding that went away is pruned, multiset-aware
    kept, removed = prune_baseline(path, findings[:1])
    assert (kept, removed) == (1, 2)
    assert sum(load_baseline(path).values()) == 1


def test_shipped_baseline_is_empty():
    path = os.path.join(REPO, "dhqr_tpu_torch", "analysis",
                        "lint_baseline.json")
    assert not load_baseline(path), (
        "the port's shipped baseline stays empty: fix or suppress with a "
        "reason, never baseline")


# -- the torch forms: inline bad/good pairs ---------------------------------

DHQR001_BAD = """\
import torch
import torch._dynamo
from torch._C import _get_tracing_state
from torch.utils import _python_dispatch
import jax.numpy as jnp
from dhqr_tpu.ops import blocked
import jaxlib
"""
DHQR001_GOOD = """\
import torch
from torch.utils.data import DataLoader
try:
    from torch._C import _get_tracing_state
except ImportError:
    _get_tracing_state = None
from dhqr_tpu_torch.ops import blocked
"""


def test_dhqr001_private_torch_and_foreign_imports():
    assert _hits(scan_source(DHQR001_BAD, PKG), "DHQR001") == \
        [2, 3, 4, 5, 6, 7]
    assert scan_source(DHQR001_GOOD, PKG) == []
    # chip_smoke.py imports nothing of JAX either; the tests import both
    assert _hits(scan_source(DHQR001_BAD, "chip_smoke.py"), "DHQR001") == \
        [2, 3, 4, 5, 6, 7]
    assert _hits(scan_source(DHQR001_BAD, "tests/test_torch_x.py"),
                 "DHQR001") == [2, 3, 4]
    # the one named shim module may hold private torch imports
    assert scan_source(DHQR001_BAD, "dhqr_tpu_torch/utils/compat.py") == []


DHQR002_BAD = """\
import torch
from dhqr_tpu_torch.ops import gemm
def f(a, b, c):
    x = a @ b
    y = torch.matmul(a, b) + torch.mm(a, b) + a.bmm(b)
    z = torch.einsum("ij,jk->ik", a, b)
    w = torch.addmm(c, a, b) + torch.baddbmm(c, a, b)
    return gemm.matmul(a, b) + torch.tensordot(a, b, 1)
"""
DHQR002_GOOD = """\
import torch
from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.gemm import matmul as mm
def f(a, b, c, p):
    x = gemm.matmul(a, b, "highest")
    y = gemm.addmm(c, a, b, p, alpha=1)
    z = mm(a, b, precision=p)
    w = a @ b  # dhqr: """ + """ignore[DHQR002] f64 check, no policy product
    return x + y + z + w
"""


def test_dhqr002_contractions_name_their_precision():
    findings = scan_source(DHQR002_BAD, PKG)
    assert _hits(findings, "DHQR002") == [4, 5, 5, 5, 6, 7, 7, 8, 8]
    good = scan_source(DHQR002_GOOD, PKG)
    assert _hits(good, "DHQR002") == []
    assert [f.line for f in good if f.suppressed] == [8]
    # the gemm module itself and code outside the package are exempt
    assert scan_source(DHQR002_BAD, "dhqr_tpu_torch/ops/gemm.py") == []
    assert scan_source(DHQR002_BAD, "tests/test_torch_x.py") == []


DHQR003_BAD = """\
import torch
def setup():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("high")
    torch.use_deterministic_algorithms(True)
    torch.set_default_dtype(torch.float64)
    torch.set_default_device("cuda")
"""
DHQR003_GOOD = """\
import torch
def check():
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on")
    return torch.get_float32_matmul_precision(), torch.get_default_dtype()
"""


def test_dhqr003_torch_process_wide_switches():
    assert _hits(scan_source(DHQR003_BAD, PKG), "DHQR003") == \
        [3, 4, 5, 6, 7, 8]
    assert scan_source(DHQR003_GOOD, PKG) == []
    for sanctioned in ("tests/conftest.py", "chip_smoke.py",
                       "benchmarks/torch_bench.py",
                       "dhqr_tpu_torch/utils/platform.py"):
        assert scan_source(DHQR003_BAD, sanctioned) == [], sanctioned
    for unsanctioned in ("tests/test_torch_chip_smoke.py",
                         "dhqr_tpu_torch/utils/platform_x.py",
                         "my_benchmarks/util.py"):
        assert _hits(scan_source(DHQR003_BAD, unsanctioned), "DHQR003"), \
            unsanctioned


DHQR004_BAD = """\
import torch
from functools import partial
def _impl(A, b):
    return float(A.norm()) * b
def _helper(x):
    return x.sum().item()
def bucket_program(kind):
    def fn(A, b):
        n = A.norm().item() + _helper(b)
        if bool(torch.isnan(b).any()):
            b = b.cpu()
        torch.cuda.synchronize()
        return A.tolist(), n
    return fn
def key_program(key):
    return partial(_impl)
"""
DHQR004_GOOD = """\
import torch
def bucket_program(kind, refine):
    steps = int(refine)
    def fn(A, b):
        m, n = int(A.shape[-2]), int(A.shape[-1])
        k = int(len(b) // 2) + int(A.numel() > 0)
        return torch.where(torch.isfinite(A), A, 0.0)[..., :n] * steps, k
    return fn
def eager_helper(A):
    return float(A.norm().item())
"""


def test_dhqr004_host_sync_in_captured_bodies():
    assert _hits(scan_source(DHQR004_BAD, PKG), "DHQR004") == \
        [4, 6, 9, 10, 11, 12, 13]
    assert scan_source(DHQR004_GOOD, PKG) == []


DHQR005_BAD = """\
import torch.distributed as dist
from torch.distributed import all_reduce
def f(x, walls, mesh):
    dist.all_reduce(x)
    dist.broadcast(x, 0, group=None)
    all_reduce(x, op=dist.ReduceOp.SUM)
    dist.all_gather_object(walls, 1.0)
    dist.barrier()
"""
DHQR005_GOOD = """\
import torch.distributed as dist
def f(x, walls, mesh):
    dist.all_reduce(x, group=mesh.group)
    dist.broadcast(x, mesh.global_rank(0), group=mesh.group)
    dist.all_gather_object(walls, 1.0, group=mesh.group)
    dist.barrier(group=mesh.group)
    return dist.get_rank(mesh.group), dist.get_world_size()
"""


def test_dhqr005_collectives_name_their_group():
    assert _hits(scan_source(DHQR005_BAD, PKG), "DHQR005") == \
        [4, 5, 6, 7, 8]
    assert scan_source(DHQR005_GOOD, PKG) == []


DHQR007_BAD = """\
import torch
import torch.linalg as tla
from torch.linalg import cholesky_ex as chx
def f(G):
    L = torch.linalg.cholesky(G)
    L2, info = torch.linalg.cholesky_ex(G)
    L3 = torch.cholesky(G)
    L4 = tla.cholesky(G)
    return chx(G), L, L2, L3, L4
"""
DHQR007_GOOD = """\
from dhqr_tpu_torch.numeric.guards import checked_cholesky
def cholesky(G):
    return checked_cholesky(G)
def f(G):
    return cholesky(G), checked_cholesky(G)
"""


def test_dhqr007_direct_cholesky_calls():
    assert _hits(scan_source(DHQR007_BAD, PKG), "DHQR007") == \
        [5, 6, 7, 8, 9]
    assert scan_source(DHQR007_GOOD, PKG) == []
    assert scan_source(DHQR007_BAD,
                       "dhqr_tpu_torch/numeric/guards.py") == []


DHQR009_BAD = """\
import torch.distributed as dist
from torch.distributed import all_gather as ag
def shard(x, outs, mesh):
    dist.broadcast(x, 0, group=mesh.group)
    dist.all_reduce(x, group=mesh.group)
    ag(outs, x, group=mesh.group)
"""
DHQR009_GOOD = """\
import torch.distributed as dist
from dhqr_tpu_torch.parallel import wire
def shard(x, mesh, comms):
    x = wire.wire_broadcast(x, 0, mesh, comms)
    dist.barrier(group=mesh.group)
    return x, dist.get_rank(mesh.group)
"""


def test_dhqr009_raw_collectives_outside_the_wire_seam():
    assert _hits(scan_source(DHQR009_BAD, PAR), "DHQR009") == [4, 5, 6]
    assert scan_source(DHQR009_GOOD, PAR) == []
    # the seam module and the single-device tier are out of scope
    assert _hits(scan_source(DHQR009_BAD,
                             "dhqr_tpu_torch/parallel/wire.py"),
                 "DHQR009") == []
    assert _hits(scan_source(DHQR009_BAD, PKG), "DHQR009") == []


DHQR010_BAD = """\
from dhqr_tpu_torch.obs import pulse as _pulse
def sharded_thing_qr(A, mesh):
    def dispatch(comms):
        return _pulse.observed_dispatch("label", lambda: A, mesh=mesh)
    return dispatch(None)
def sharded_other(A, mesh):
    return _pulse.observed_dispatch("label", lambda: A, mesh=mesh)
"""
DHQR010_GOOD = """\
from dhqr_tpu_torch import armor as _armor
from dhqr_tpu_torch.obs import pulse as _pulse
def _result(label, dispatch):
    return _armor.checked_dispatch(label, dispatch, lambda x: (0.0, None),
                                   engine="householder", comms=None)
def sharded_thing_qr(A, mesh):
    def dispatch(comms):
        return _pulse.observed_dispatch("label", lambda: A, mesh=mesh)
    return _result("label", lambda: dispatch(None))
def sharded_solve(A, b, mesh):
    return _armor.checked_solve("l", lambda c: _pulse.observed_dispatch(
        "l", lambda: b, mesh=mesh), A, b, engine="tsqr", comms=None,
        plan_shape=())
def sharded_chain(A, mesh):
    return sharded_thing_qr(A, mesh)
"""


def test_dhqr010_sharded_dispatch_outside_the_armor_seam():
    assert _hits(scan_source(DHQR010_BAD, PAR), "DHQR010") == [2, 6]
    assert scan_source(DHQR010_GOOD, PAR) == []
    assert _hits(scan_source(DHQR010_BAD, PKG), "DHQR010") == []


@pytest.mark.parametrize("mod", ["sharded_qr", "sharded_solve",
                                 "sharded_tsqr", "sharded_cholqr"])
def test_dhqr010_live_sharded_engines_dispatch_through_armor(mod):
    path = f"dhqr_tpu_torch/parallel/{mod}.py"
    with open(os.path.join(REPO, path), "r", encoding="utf-8") as fh:
        text = fh.read()
    assert "observed_dispatch" in text   # the rule's "builds" applies
    assert _hits(scan_source(text, path), "DHQR010") == []


# -- the gate ----------------------------------------------------------------

def test_self_scan_port_and_its_tests_clean():
    findings = scan_paths(cli.default_paths(), rel_to=REPO)
    active = [f for f in findings if not f.suppressed]
    assert active == [], "new lint findings:\n" + "\n".join(
        f.render() for f in active)
    assert all(f.reason for f in findings if f.suppressed), (
        "every suppression must carry a reason")
    paths = {f.path for f in scan_paths(
        [os.path.join(REPO, "dhqr_tpu_torch", "analysis")], rel_to=REPO)}
    assert not paths, "the lint package itself scans clean, unsuppressed"


def test_default_scan_covers_the_port_its_smoke_run_and_tests():
    paths = [os.path.relpath(p, REPO) for p in cli.default_paths()]
    assert paths[:2] == ["dhqr_tpu_torch", "chip_smoke.py"]
    tests = paths[2:]
    assert tests and all(p.startswith(os.path.join("tests", "test_torch_"))
                         for p in tests)
    assert os.path.join("tests", "test_torch_analysis.py") in tests


def test_no_module_of_the_port_imports_jax():
    findings = scan_paths([os.path.join(REPO, "dhqr_tpu_torch"),
                           os.path.join(REPO, "chip_smoke.py")],
                          rules=(ast_rules.PrivateImports(),), rel_to=REPO)
    assert findings == []


def test_api_table_documents_every_export():
    from dhqr_tpu_torch.analysis.api_check import check_api

    assert check_api() == []


def test_api_check_catches_an_undocumented_name(tmp_path):
    from dhqr_tpu_torch.analysis.api_check import check_api

    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        doc = fh.read()
    readme = tmp_path / "README.md"
    readme.write_text(doc.replace("`UpdatableQR`", "`Updatable`"))
    missing = [f.snippet for f in check_api(str(readme))
               if f.rule == "DHQR202"]
    assert missing == ["UpdatableQR"]
    readme.write_text(doc.replace("### Public API", "### API"))
    assert any("no '### Public API'" in f.message
               for f in check_api(str(readme)))


def test_cli_exit_codes_and_json(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(DHQR003_BAD)
    assert cli.main(["check", str(bad), "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in out["findings"]] == ["DHQR003"] * 6
    assert set(out) == {"findings", "warnings", "suppressed", "baselined"}
    good = tmp_path / "good.py"
    good.write_text(DHQR003_GOOD)
    assert cli.main(["check", str(good)]) == 0
    assert cli.main(["check", str(tmp_path / "typo.py")]) == 2
    assert "typo.py" in capsys.readouterr().err
    base = tmp_path / "base.json"
    assert cli.main(["check", str(bad), "--write-baseline",
                     str(base)]) == 0
    assert cli.main(["check", str(bad), "--baseline", str(base)]) == 0
    assert cli.main(["check", str(bad), "--prune-baseline"]) == 2


def test_cli_fast_self_scan_is_green(capsys):
    assert cli.main(["check", "--fast"]) == 0
    assert "0 finding(s)" in capsys.readouterr().err


def test_cli_graph_passes_raise_naming_item_18b(tmp_path):
    """Item 18b landed: the interim flags that raised are gone (argparse
    refuses them), the JAX CLI's ``--no-*`` flags skip the graph passes,
    and no pass raises ``NotPortedError``."""
    good = tmp_path / "good.py"
    good.write_text(DHQR003_GOOD)
    for flag in ("--jaxpr", "--comms", "--atlas", "--xray", "--pulse"):
        with pytest.raises(SystemExit):
            cli.main(["check", str(good), flag])
        assert cli.main(["check", str(good), "--no-" + flag[2:]]) == 0
    assert not hasattr(cli, "PENDING_PASSES")


def test_list_rules(capsys):
    assert cli.main(["--list-rules"]) == 0
    rules = [line.split()[0] for line in
             capsys.readouterr().out.splitlines()]
    assert rules == sorted(rules)
    graph = {f"DHQR{i}" for i in (101, 102, 103, 104, 301, 302, 303, 304,
                                  305, 306, 401, 402, 501, 502, 503, 504,
                                  505)}
    assert {f"DHQR{i:03d}" for i in range(11)} | {"DHQR201", "DHQR202",
                                                  "DHQR601", "DHQR602",
                                                  "DHQR603", "DHQR604"} \
        | graph == set(rules)
