"""Key store and shared fleet state — port of ``dhqr_tpu/serve/store.py``.

Two cross-process tiers, as in the JAX package:

* :class:`ExecutableStore` — a directory under the serve cache, one file
  per key, keyed by the JAX package's cross-process spelling of the
  :class:`~dhqr_tpu_torch.serve.cache.CacheKey`
  (:func:`~dhqr_tpu_torch.serve.cache.canonical_key`, byte for byte). In
  the JAX package each file holds a serialized executable, and a new
  replica's ``prewarm()`` deserializes instead of compiling. **A CUDA graph
  cannot be serialized**: it holds raw device addresses of one process's
  memory pool, and PyTorch has no counterpart of
  ``jax.experimental.serialize_executable``. So what the port writes per
  key is the key's record (its fields, how its program ran and on which
  device), and :meth:`ExecutableStore.load` never returns a program: it
  returns ``(None, reason)``, the reason spelled out
  (:data:`NOT_A_PROGRAM` for a key an earlier process recorded), counted
  under ``fleet.store.*`` and never raised on a dispatch path, so a new
  replica recaptures. What is kept of the JAX store: the spelling, the
  tempfile-then-rename single-writer write (a reader never sees a torn
  file), the tolerance of corrupt, truncated and version-skewed files (the
  ``serve.store`` fault site models them), the explicit disk-side
  :meth:`~ExecutableStore.evict`, and the counters' names, less those of a
  deserialized program (``disk_hits``, ``deserialize_seconds``), which
  this store cannot have; ``records_found`` counts the keys an earlier
  process recorded instead. The environment fingerprint names torch, CUDA
  and the card.
* **Fleet state** (:func:`save_fleet_state` / :func:`load_fleet_state`) —
  the verdicts a replica learns against live traffic, merged
  last-write-wins under an advisory file lock: compile quarantines (the
  serve cache's cooldowns, spelled canonically), the tuner's plan-gate
  failure counts and the armor seam's wire trips, in the JAX package's
  spelling, so a file written by either package reads in the other.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import time
import warnings

import torch

from dhqr_tpu_torch.faults import harness as _faults
from dhqr_tpu_torch.obs import metrics as _obs_metrics
from dhqr_tpu_torch.serve.cache import CacheKey, canonical_key, default_cache
from dhqr_tpu_torch.utils import lockwitness as _lockwitness
from dhqr_tpu_torch.utils.config import FleetConfig
from dhqr_tpu_torch.utils.profiling import Counters

#: On-disk record schema (one JSON header line + the JSON record).
BLOB_SCHEMA = "dhqr-exe-store"
BLOB_VERSION = 1

STATE_SCHEMA = "dhqr-fleet-state"
STATE_VERSION = 1

#: The reason :meth:`ExecutableStore.load` gives for a key it holds.
NOT_A_PROGRAM = ("recorded by an earlier process, but a CUDA graph does "
                 "not outlive its process: recapture")


def _env_fingerprint() -> str:
    """What a record was made under: torch, its CUDA and the card (part
    of the file name's digest, so a skewed store reads as a clean miss)."""
    card = torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"
    return f"torch {torch.__version__}|cuda {torch.version.cuda}|{card}"


class ExecutableStore:
    """The disk tier under the serve cache: one directory of atomically
    written, checksummed key records shared by every replica on the host.

    ``load(key)`` returns ``(None, reason)`` and ``save(key, compiled)``
    ``None`` or the reason it could not write; neither raises on the
    serving path. Layout as in the JAX package: one ``<sha256>.dhqrx`` file
    per key, the digest over the canonical spelling and the environment
    fingerprint, each file one JSON header line (schema, key, fingerprint,
    payload sha256) and the payload, here the key's JSON record."""

    def __init__(self, root: "str | None" = None,
                 clock=time.monotonic) -> None:
        if root is None:
            root = FleetConfig.from_env().store_dir
        if not root:
            raise ValueError(
                "ExecutableStore needs a directory: pass root= or set "
                "DHQR_FLEET_STORE")
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._clock = clock  # as the JAX package's: kept, read nowhere
        self._lock = _lockwitness.make_lock("ExecutableStore._lock")
        self.counters = Counters()
        self.last_reason: "str | None" = None  # guarded by: _lock
        _obs_metrics.registry().register("fleet.store", self)

    def _path(self, key_str: str) -> str:
        digest = hashlib.sha256(
            (_env_fingerprint() + "\n" + key_str).encode("utf-8")
        ).hexdigest()
        return os.path.join(self.root, digest + ".dhqrx")

    # -- read --------------------------------------------------------------
    def read_record(self, key) -> "tuple[dict | None, str | None]":
        """``(record, None)`` for a key an earlier process wrote whole,
        ``(None, reason)`` otherwise (absent, corrupt, skewed, or the
        ``serve.store`` fault site firing). Counts nothing."""
        try:
            key_str = canonical_key(key)
        except ValueError as e:
            return None, str(e)
        path = self._path(key_str)
        if not os.path.exists(path):
            return None, "absent"
        try:
            _faults.fire("serve.store")
            with open(path, "rb") as fh:
                raw = fh.read()
            head, sep, payload = raw.partition(b"\n")
            if not sep:
                raise ValueError("truncated record (no header line)")
            header = json.loads(head.decode("utf-8"))
            if header.get("schema") != BLOB_SCHEMA or \
                    header.get("version") != BLOB_VERSION:
                raise ValueError(
                    f"foreign/stale record schema {header.get('schema')!r}"
                    f" v{header.get('version')!r}")
            if header.get("key") != key_str:
                raise ValueError(
                    "digest collision or renamed record: header key "
                    f"{header.get('key')!r:.120} != requested")
            if header.get("fingerprint") != _env_fingerprint():
                raise ValueError(
                    f"version skew: recorded under "
                    f"{header.get('fingerprint')!r}")
            if header.get("sha256") != hashlib.sha256(payload).hexdigest():
                raise ValueError("payload checksum mismatch "
                                 "(truncated or corrupt record)")
            record = json.loads(payload.decode("utf-8"))
        except Exception as e:
            return None, (str(e) if isinstance(e, ValueError)
                          else f"{type(e).__name__}: {e}")
        self.counters.bump("read_bytes", len(raw))
        return record, None

    def load(self, key) -> "tuple[None, str]":
        """``(None, reason)``, always: a counted ``disk_misses``, plus
        ``records_found`` for a key an earlier process recorded (reason
        :data:`NOT_A_PROGRAM`) or ``deserialize_failures`` for a present
        but unreadable, corrupt or skewed file. The caller captures."""
        record, reason = self.read_record(key)
        if record is not None:
            self.counters.bump("records_found")
            reason = NOT_A_PROGRAM
        elif reason != "absent" and not reason.startswith("no canonical"):
            self.counters.bump("deserialize_failures")
        self.counters.bump("disk_misses")
        with self._lock:
            self.last_reason = reason
        return None, reason

    # -- write -------------------------------------------------------------
    def save(self, key, compiled) -> "str | None":
        """Record one compiled key; ``None`` on success, else the reason
        (counted ``serialize_failures``). Single-writer atomic: the record
        goes to a tempfile in the store directory, then ``os.replace``, so
        two writers of one key both succeed and the later rename wins
        with a whole file."""
        try:
            key_str = canonical_key(key)
        except ValueError as e:
            self.counters.bump("serialize_failures")
            return str(e)
        record = {
            "fields": list(key) if isinstance(key, CacheKey) else None,
            "program": getattr(compiled, "mode", type(compiled).__name__),
            "device": str(getattr(compiled, "device", "")),
        }
        payload = json.dumps(record, sort_keys=True).encode("utf-8")
        header = json.dumps({
            "schema": BLOB_SCHEMA, "version": BLOB_VERSION,
            "key": key_str, "fingerprint": _env_fingerprint(),
            "sha256": hashlib.sha256(payload).hexdigest(),
            "payload_bytes": len(payload),
        }, sort_keys=True).encode("utf-8")
        try:
            _atomic_write(self._path(key_str), header + b"\n" + payload,
                          self.root, ".dhqrx-")
        except Exception as e:
            # a full disk or a read-only store: the capture that produced
            # the program already succeeded
            self.counters.bump("serialize_failures")
            return f"store write failed: {type(e).__name__}: {e}"
        self.counters.bump("puts")
        self.counters.bump("put_bytes", len(payload))
        return None

    # -- maintenance -------------------------------------------------------
    def evict(self, key) -> bool:
        """Delete ``key``'s record (the explicit disk-side eviction; the
        cache's LRU never touches the disk). True if one existed."""
        try:
            path = self._path(canonical_key(key))
        except ValueError:
            return False
        try:
            os.unlink(path)
        except FileNotFoundError:
            return False
        self.counters.bump("disk_evictions")
        return True

    def clear(self) -> int:
        """Delete every record in the directory; returns the count."""
        n = 0
        for name in os.listdir(self.root):
            if not name.endswith(".dhqrx"):
                continue
            with contextlib.suppress(OSError):  # a concurrent evict
                os.unlink(os.path.join(self.root, name))
                n += 1
        if n:
            self.counters.bump("disk_evictions", n)
        return n

    def keys(self) -> "list[str]":
        """Canonical spellings of every readable record (sorted)."""
        out = []
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".dhqrx"):
                continue
            try:
                with open(os.path.join(self.root, name), "rb") as fh:
                    header = json.loads(fh.readline().decode("utf-8"))
            except (OSError, ValueError):
                continue  # a torn or foreign file lists as absent
            if isinstance(header, dict) and isinstance(header.get("key"),
                                                       str):
                out.append(header["key"])
        return sorted(out)

    def cache_keys(self) -> "list[CacheKey]":
        """The :class:`CacheKey`\\ s of every whole record made under this
        environment: the key set an earlier replica captured, for a new
        one to capture ahead of traffic (``prewarm_keys``)."""
        out = []
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".dhqrx"):
                continue
            try:
                with open(os.path.join(self.root, name), "rb") as fh:
                    fields = json.loads(
                        fh.read().partition(b"\n")[2]).get("fields")
                key = CacheKey(*fields[:12], sketch=None if fields[12]
                               is None else tuple(fields[12]))
            except (OSError, ValueError, TypeError, IndexError,
                    AttributeError):
                continue
            record, _ = self.read_record(key)
            if record is not None:
                out.append(key)
        return out

    # -- accounting --------------------------------------------------------
    def stats(self) -> dict:
        """Counter snapshot + occupancy, JSON-ready; identical to
        :meth:`metrics_snapshot`."""
        return self.metrics_snapshot()

    def metrics_snapshot(self) -> dict:
        """The registry-facing snapshot (``fleet.store.*``)."""
        snap = self.counters.snapshot()
        try:
            blobs = sum(1 for name in os.listdir(self.root)
                        if name.endswith(".dhqrx"))
        except OSError:
            blobs = 0
        out = {"blobs": blobs}
        for name in ("disk_misses", "records_found", "deserialize_failures",
                     "serialize_failures", "puts", "put_bytes", "read_bytes",
                     "disk_evictions"):
            out[name] = int(snap.get(name, 0))
        return out


def _atomic_write(path: str, data: bytes, directory: str,
                  prefix: str) -> None:
    """Write ``data`` to a tempfile in ``directory``, then rename it over
    ``path``: a reader sees the old file or the new one, never a torn
    one."""
    fd, tmp = tempfile.mkstemp(prefix=prefix, dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def prewarm_keys(keys, cache=None, device=None) -> "list[CacheKey]":
    """Capture ``keys`` (e.g. a store's :meth:`~ExecutableStore.
    cache_keys`) into ``cache`` ahead of traffic; returns them. The
    warm-start of a replica whose store holds records, not programs."""
    from functools import partial

    from dhqr_tpu_torch.serve import engine as _engine
    from dhqr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cache = default_cache(dev) if cache is None else cache
    keys = list(keys)
    for key in keys:
        cache.get_or_compile(key, partial(_engine._lower_for_key, key, dev))
    return keys


# -- process-default store --------------------------------------------------
# Lazy like the default cache: a malformed DHQR_FLEET_* fails the serve
# call that reads it, never the import.
_DEFAULT_STORE: "ExecutableStore | None" = None
_DEFAULT_STORE_LOCK = _lockwitness.make_lock("store._DEFAULT_STORE_LOCK")


def default_store() -> "ExecutableStore | None":
    """The process-default store, or None when ``DHQR_FLEET_STORE`` is
    unset (the per-process cache)."""
    global _DEFAULT_STORE
    if _DEFAULT_STORE is None:
        with _DEFAULT_STORE_LOCK:
            if _DEFAULT_STORE is None:
                fcfg = FleetConfig.from_env()
                if not fcfg.store_dir:
                    return None
                _DEFAULT_STORE = ExecutableStore(fcfg.store_dir)
    return _DEFAULT_STORE


def reset_default_store() -> None:
    """Drop the cached process-default store (tests; or after changing
    ``DHQR_FLEET_STORE``)."""
    global _DEFAULT_STORE
    with _DEFAULT_STORE_LOCK:
        _DEFAULT_STORE = None


# ---------------------------------------------------------------------------
# Shared fleet state.

# One warning per (path, reason) per process.
_WARNED: "set[tuple[str, str]]" = set()
_WARN_LOCK = _lockwitness.make_lock("store._WARN_LOCK")


def _warn_once(path: str, reason: str, detail: str) -> None:
    with _WARN_LOCK:
        if (path, reason) in _WARNED:
            return
        _WARNED.add((path, reason))
    warnings.warn(
        f"fleet state {path}: {detail} — continuing with this process's "
        "own verdicts only (delete the file to rebuild)",
        stacklevel=3,
    )


def export_fleet_state(cache=None, wall=time.time) -> dict:
    """This process's serving verdicts in the shared JSON spelling:
    active compile quarantines (canonical key -> wall-clock expiry), the
    plan numeric-gate failure counts (tune plan key -> count) and the
    armor wire-trip counts."""
    from dhqr_tpu_torch import armor as _armor
    from dhqr_tpu_torch.tune.search import plan_gate_stats

    cache = default_cache() if cache is None else cache
    return {
        "quarantines": cache.export_quarantines(wall=wall),
        "gate_failures": {
            k: int(v) for k, v in
            plan_gate_stats().get("failures", {}).items()},
        "wire_trips": _armor.export_wire_trips(),
    }


def adopt_fleet_state(state: dict, cache=None, wall=time.time) -> None:
    """Inherit another replica's verdicts: quarantines land in the cache's
    adopted-cooldown map, gate failures and wire trips merge by MAX into
    the tuner and the armor seam (a count is monotone evidence)."""
    from dhqr_tpu_torch import armor as _armor
    from dhqr_tpu_torch.tune.search import adopt_gate_failures

    cache = default_cache() if cache is None else cache
    cache.adopt_quarantines(state.get("quarantines") or {}, wall=wall)
    adopt_gate_failures(state.get("gate_failures") or {})
    _armor.adopt_wire_trips(state.get("wire_trips") or {})


def _merge_state(disk: dict, ours: dict, wall_now: float) -> dict:
    """Union two state snapshots: counts by MAX, quarantine expiries by
    latest, expired quarantines pruned (the JAX package's rule)."""
    quarantines = {}
    for src in (disk.get("quarantines") or {}, ours.get("quarantines")
                or {}):
        for key, expiry in src.items():
            try:
                expiry = float(expiry)
            except (TypeError, ValueError):
                continue
            if expiry <= wall_now:
                continue
            quarantines[str(key)] = max(
                quarantines.get(str(key), expiry), expiry)
    out = {"quarantines": quarantines}
    for section in ("gate_failures", "wire_trips"):
        merged: "dict[str, int]" = {}
        for src in (disk.get(section) or {}, ours.get(section) or {}):
            for key, count in src.items():
                try:
                    count = int(count)
                except (TypeError, ValueError):
                    continue
                merged[str(key)] = max(merged.get(str(key), 0), count)
        out[section] = merged
    return out


def _load_state_file(path: str) -> dict:
    """Tolerantly read one fleet-state file (corrupt, foreign or stale
    degrades to empty with a one-time warning)."""
    empty = {"quarantines": {}, "gate_failures": {}, "wire_trips": {}}
    if not os.path.exists(path):
        return empty
    try:
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
    except (OSError, ValueError) as e:
        _warn_once(path, "corrupt",
                   f"unreadable ({type(e).__name__}: {e})")
        return empty
    if not isinstance(raw, dict) or raw.get("schema") != STATE_SCHEMA:
        _warn_once(path, "schema",
                   "not a dhqr fleet-state file (missing/foreign schema)")
        return empty
    if raw.get("version") != STATE_VERSION:
        _warn_once(path, "version",
                   f"schema version {raw.get('version')!r} != "
                   f"{STATE_VERSION} (stale or future file)")
        return empty
    out = {}
    for section in ("quarantines", "gate_failures", "wire_trips"):
        val = raw.get(section)
        out[section] = val if isinstance(val, dict) else {}
    return out


@contextlib.contextmanager
def _file_lock(path: str):
    """Advisory inter-process lock (``flock`` on ``path + ".lock"``, the
    JAX package's ``PlanDB._file_lock``) for the read-merge-replace
    window; without ``fcntl`` the save runs unlocked."""
    try:
        import fcntl
    except ImportError:  # non-POSIX: keep working, racy
        yield
        return
    fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        with _lockwitness.witness_region("store._file_lock"):
            yield
    finally:
        os.close(fd)  # closing releases the flock


def state_payload(merged: dict) -> bytes:
    """The bytes a fleet-state file holds for ``merged`` (sorted keys, one
    space of indent, a trailing newline: the JAX package's spelling)."""
    payload = {"schema": STATE_SCHEMA, "version": STATE_VERSION,
               **{k: dict(sorted(v.items())) for k, v in merged.items()}}
    return (json.dumps(payload, indent=1, sort_keys=True)
            + "\n").encode("utf-8")


def save_fleet_state(path: "str | None" = None, cache=None,
                     wall=time.time) -> str:
    """Merge-write this process's verdicts to the shared state file
    (read-merge-replace under the file lock: concurrent replicas union
    their verdicts)."""
    path = path or FleetConfig.from_env().state_path
    if not path:
        raise ValueError(
            "no state path: pass save_fleet_state(path) or set "
            "DHQR_FLEET_STATE")
    ours = export_fleet_state(cache=cache, wall=wall)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    with _file_lock(path):
        merged = _merge_state(_load_state_file(path), ours, wall())
        _atomic_write(path, state_payload(merged), directory,
                      ".dhqrfleet-")
    return path


def load_fleet_state(path: "str | None" = None, cache=None,
                     wall=time.time) -> dict:
    """Read the shared state file (tolerantly) and adopt its verdicts;
    returns the snapshot read. A new replica calls this (and ``prewarm``)
    before taking traffic."""
    path = path or FleetConfig.from_env().state_path
    if not path:
        raise ValueError(
            "no state path: pass load_fleet_state(path) or set "
            "DHQR_FLEET_STATE")
    state = _load_state_file(path)
    adopt_fleet_state(state, cache=cache, wall=wall)
    return state


__all__ = [
    "ExecutableStore",
    "NOT_A_PROGRAM",
    "adopt_fleet_state",
    "default_store",
    "export_fleet_state",
    "load_fleet_state",
    "prewarm_keys",
    "reset_default_store",
    "save_fleet_state",
]
