"""PyTorch port: dhqr-warden, the DHQR6xx lock-discipline pass over
``dhqr_tpu_torch`` — the twin of ``tests/test_concurrency_pass.py``.

The JAX package's DHQR601-604 fixtures (read only) give the same
findings and edges through both packages' scanners; the port's own
additions (the card's blocking calls, the lane-lock resolutions) are
held on inline sources with exact rule IDs and lines. Then the port's
committed lock-order graph (loads, acyclic, every edge with its site and
proof, the lane edges present), the static self-scan, and the CPU
lock-witness burst within the committed graph. On the card the same
burst captures and replays CUDA graphs under the lane locks
(``chip_smoke.py`` phase 21 (b)). Every case here runs in seconds.
"""

import os
import time

import pytest

pytest.importorskip("torch")

from dhqr_tpu.analysis.concurrency_pass import (  # noqa: E402
    _scan_text as _jscan_text,
)

from dhqr_tpu_torch.analysis.concurrency_pass import (  # noqa: E402
    EDGES_PATH,
    LANE_LOCK,
    _graph_findings,
    _scan_text,
    _witness_workload,
    find_cycle,
    load_edges,
    run_concurrency_pass,
    scan_concurrency_source,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")
SERVE = "dhqr_tpu_torch/serve/_fixture.py"

pytestmark = pytest.mark.lint


def _fixture(name):
    with open(os.path.join(FIXTURES, name), "r", encoding="utf-8") as fh:
        return fh.read()


def _hits(findings, rule):
    return sorted(f.line for f in findings
                  if f.rule == rule and not f.suppressed)


# -- the JAX fixtures through both scanners ----------------------------------

@pytest.mark.parametrize("name", [f"dhqr60{i}_{kind}.py" for i in range(1, 5)
                                  for kind in ("bad", "good")])
def test_jax_fixtures_give_the_same_findings_and_edges(name):
    text = _fixture(name)
    mine, my_edges = _scan_text(text, SERVE)
    theirs, their_edges = _jscan_text(text, "dhqr_tpu/serve/_fixture.py")
    assert [(f.rule, f.line, f.suppressed, f.reason) for f in mine] == \
        [(f.rule, f.line, f.suppressed, f.reason) for f in theirs]
    assert set(my_edges) == set(their_edges)


# -- DHQR601: guarded-field discipline ---------------------------------------

DHQR601_BAD = """\
import threading
from dhqr_tpu_torch.utils import lockwitness as _lw
class Lanes:
    def __init__(self):
        self._lock = _lw.make_lock("Lanes._lock")
        self._table: dict = {}          # guarded by: _lock
        self._names = ("a", "b")        # guarded by: frozen
        self._pending = []
    def count(self):
        return len(self._table)
    def add(self, k, v):
        self._table[k] = v
    def rename(self):
        self._names = ()
"""
DHQR601_GOOD = """\
from dhqr_tpu_torch.utils import lockwitness as _lw
class Lanes:
    def __init__(self):
        self._lock = _lw.make_lock("Lanes._lock")
        self._table: dict = {}          # guarded by: _lock
        self._names = ("a", "b")        # guarded by: frozen
    def count(self):
        with self._lock:
            return self._count_locked()
    def _count_locked(self):
        return len(self._table)
    def names(self):
        return self._names
"""


def test_dhqr601_guarded_field_discipline():
    assert _hits(scan_concurrency_source(DHQR601_BAD, SERVE), "DHQR601") \
        == [8, 10, 12, 14]
    assert scan_concurrency_source(DHQR601_GOOD, SERVE) == []


# -- DHQR602: lock-order graph -----------------------------------------------

DHQR602_BAD = """\
from dhqr_tpu_torch.utils import lockwitness as _lw
_TABLE_LOCK = _lw.make_lock("cache._TABLE_LOCK")
class Cache:
    def __init__(self):
        self._lock = _lw.make_rlock("Cache._lock")
    def compile(self):
        with self._lock:
            with _TABLE_LOCK:
                pass
    def evict(self):
        with _TABLE_LOCK:
            self._drop()
    def _drop(self):
        with self._lock:
            pass
"""


def test_dhqr602_extracts_nesting_and_one_call_level():
    _, edges = _scan_text(DHQR602_BAD, "fx.py")
    assert edges == {("Cache._lock", "cache._TABLE_LOCK"): "fx.py:8",
                     ("cache._TABLE_LOCK", "Cache._lock"): "fx.py:12"}
    findings = _graph_findings(edges, [], "lock_order.json")
    assert _hits(findings, "DHQR602") == [0, 8, 12]
    assert len([f for f in findings if "cycle" in f.message]) == 1


def test_dhqr602_committed_edge_green_and_stale_red():
    edges = {("Cache._lock", "cache._TABLE_LOCK"): "fx.py:8"}
    committed = [{"from": "Cache._lock", "to": "cache._TABLE_LOCK",
                  "source": "static"}]
    assert _graph_findings(edges, committed, "lock_order.json") == []
    stale = committed + [{"from": "Cache._lock", "to": "X._lock",
                          "source": "static"}]
    findings = _graph_findings(edges, stale, "lock_order.json")
    assert len(findings) == 1 and "stale" in findings[0].message


def test_find_cycle():
    assert find_cycle({("a", "b"), ("b", "c")}) is None
    cycle = find_cycle({("a", "b"), ("b", "c"), ("c", "a")})
    assert cycle is not None and cycle[0] == cycle[-1]
    assert find_cycle({(LANE_LOCK, LANE_LOCK)}) == [LANE_LOCK, LANE_LOCK]


# -- DHQR603: the card's blocking calls, and the lane resolutions ------------

DHQR603_BAD = """\
import torch
from contextlib import contextmanager
from dhqr_tpu_torch.ops import _build
from dhqr_tpu_torch.utils import lockwitness as _lw
class Lane:
    def __init__(self):
        self.lock = _lw.make_lock("serve.cache.DeviceLane.lock")
    @contextmanager
    def entered(self):
        with self.lock:
            yield
class Program:
    def __init__(self, lane):
        self.lane = lane
    def __call__(self, graph):
        with self.lane.entered():
            graph.replay()
    def capture(self, lane, graph, side):
        with lane.lock:
            torch.cuda.synchronize()
            side.synchronize()
            graph.capture_begin()
            with torch.cuda.graph(graph):
                pass
    def build(self):
        with self.lane.lock:
            return _build.load("panel_qr")
"""
DHQR603_GOOD = """\
import torch
from dhqr_tpu_torch.utils import lockwitness as _lw
class Lane:
    def __init__(self):
        self.lock = _lw.make_lock("serve.cache.DeviceLane.lock")
class Program:
    def capture(self, lane, graph):
        torch.cuda.synchronize()
        with lane.lock:
            graph.replay()  # dhqr: """ + """ignore[DHQR603] one replay per lane
        graph.capture_begin()
"""


def test_dhqr603_card_blocking_calls_under_a_lane_lock():
    findings = scan_concurrency_source(DHQR603_BAD, SERVE)
    assert _hits(findings, "DHQR603") == [17, 20, 21, 22, 23, 27]
    assert all("serve.cache.DeviceLane.lock" in f.message
               for f in findings)
    good = scan_concurrency_source(DHQR603_GOOD, SERVE)
    assert _hits(good, "DHQR603") == []
    assert [f.line for f in good if f.suppressed] == [10]


def test_dhqr603_classic_blocking_calls():
    src = ("import time, subprocess\n"
           "from dhqr_tpu_torch.utils import lockwitness as _lw\n"
           "_L = _lw.make_lock('m._L')\n"
           "def f(fut, lowered):\n"
           "    with _L:\n"
           "        fut.result()\n"
           "        time.sleep(0.1)\n"
           "        subprocess.check_call(['true'])\n"
           "        lowered.compile()\n"
           "        import re; re.compile('x')\n")
    assert _hits(scan_concurrency_source(src, SERVE), "DHQR603") == \
        [6, 7, 8, 9]


# -- DHQR604 -----------------------------------------------------------------

def test_dhqr604_unsynchronized_publication():
    src = ("from dhqr_tpu_torch.utils import lockwitness as _lw\n"
           "class Store:\n"
           "    def __init__(self):\n"
           "        self._lock = _lw.make_lock('Store._lock')\n"
           "        self.ready = False\n"
           "    def late(self):\n"
           "        self.cache = {}\n"
           "    def locked(self):\n"
           "        with self._lock:\n"
           "            self.other = 1\n"
           "        self.ready = True\n")
    assert _hits(scan_concurrency_source(src, SERVE), "DHQR604") == [7]


# -- the committed graph is a contract ---------------------------------------

def test_committed_lock_order_graph_loads_and_is_acyclic():
    edges = load_edges(EDGES_PATH)
    assert edges, "committed lock-order graph must not be empty"
    assert find_cycle({(e["from"], e["to"]) for e in edges}) is None
    for e in edges:
        assert e.get("site", "").startswith("dhqr_tpu_torch/") \
            and e.get("note"), f"every edge needs a port site and a why: {e}"
    pairs = {(e["from"], e["to"]) for e in edges}
    # the port's own locks: the lane table and the lanes (a capture)
    assert ("ExecutableCache._lock", "cache._LANES_LOCK") in pairs
    assert ("ExecutableCache._lock", LANE_LOCK) in pairs
    assert not any(b == "ExecutableCache._lock" for _, b in pairs
                   if _ == LANE_LOCK)


def test_static_self_scan_is_green():
    """The port's self-scan and the two-way graph comparison (the
    --fast twin: no witness burst)."""
    findings = run_concurrency_pass(witness=False)
    active = [f for f in findings if not f.suppressed]
    assert active == [], "\n".join(f.render() for f in active)
    # the lane lock's capture and replay are suppressed with their reason
    lane = [f for f in findings if f.suppressed
            and "DeviceLane.lock" in f.message]
    assert len(lane) >= 6 and all(f.reason for f in lane)


# -- the runtime gate --------------------------------------------------------

def test_witness_burst_within_committed_graph_on_the_cpu():
    stats = {}
    w = _witness_workload(requests=4, submit_threads=2, device="cpu",
                          stats=stats)
    committed = {(e["from"], e["to"]) for e in load_edges(EDGES_PATH)}
    unknown = [e for e in w.edges() if e not in committed]
    assert unknown == [], f"witnessed edges not committed: {unknown}"
    assert w.violations() == []
    assert find_cycle(w.edges()) is None
    assert w.stats()["acquires"] > 0
    assert ("ExecutableCache._lock", "cache._LANES_LOCK") in w.edges()
    assert stats["requests"] == 4 and stats["programs"] == {"eager": 1}


def test_full_pass_with_the_cpu_witness_is_green():
    stats = {}
    findings = [f for f in run_concurrency_pass(witness=True, device="cpu",
                                                stats=stats)
                if not f.suppressed]
    assert findings == [], "\n".join(f.render() for f in findings)
    assert stats["violations"] == 0 and stats["edges"]
    assert stats["lane_edges"] == []   # the CPU runs no capture


def test_witness_burst_refuses_the_card_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the burst runs there")
    with pytest.raises(RuntimeError):
        _witness_workload(requests=2, device=None)


def test_stress_soak_with_failover():
    """The seeded stress burst at soak size, and the failover relay of a
    killed replica, both within the committed graph."""
    committed = {(e["from"], e["to"]) for e in load_edges(EDGES_PATH)}
    t0 = time.perf_counter()
    w = _witness_workload(requests=32, submit_threads=4, arm_faults=True,
                          device="cpu")
    assert set(w.edges()) <= committed and w.violations() == []
    w2 = _witness_workload(requests=16, submit_threads=2, arm_faults=True,
                           kill_replica=True, device="cpu")
    assert set(w2.edges()) <= committed and w2.violations() == []
    assert time.perf_counter() - t0 < 120
