"""Persistent, versioned plan database — port of ``dhqr_tpu/tune/db.py``.

One JSON file maps tuning keys — ``(platform, kind, m, n, dtype, nproc,
policy)`` rendered as a string — to the measured-best :class:`Plan` plus
measurement metadata. The file's schema is the JAX package's, so a file
written by either package loads in the other. Three properties carry the
operational weight:

* **Tolerant loading.** A corrupt file, a stale or unknown schema
  version, or a malformed entry degrades to "no stored plan" with a
  one-time warning per (path, reason) — never an exception: losing a DB
  costs a re-tune, crashing on it costs the serving process.
* **Last-write-wins merging.** ``save()`` re-reads the file it is about
  to replace and merges (disk entries first, this process's on top) under
  an advisory file lock, then writes atomically via ``os.replace``.
* **Shipped seeds.** ``default_db()`` layers the packaged
  ``default_plans.json`` under the operator's writable DB. The port's file
  ships no entries: the JAX package's TPU seeds and its ``cpu:`` seeds
  measured other programs, and a ``torch-cuda`` seed is a measurement
  this package has not committed to.

The platform segment of a key is the program that was measured: the
port's default is ``torch-<device type>`` (``torch-cuda`` or
``torch-cpu``), never the JAX package's ``cpu`` / ``tpu``, so a JAX
measurement never answers for the port.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import warnings
from typing import Optional

from dhqr_tpu_torch.tune.plan import Plan
from dhqr_tpu_torch.utils import lockwitness as _lockwitness
from dhqr_tpu_torch.utils.device import dtype_name

SCHEMA = "dhqr-plan-db"
SCHEMA_VERSION = 1

#: Packaged seed database (committed, read-only).
SEED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "default_plans.json")

# One warning per (path, reason) per process: a serving loop that polls
# a corrupt DB must not drown its own logs.
_WARNED: "set[tuple[str, str]]" = set()
_WARN_LOCK = _lockwitness.make_lock("db._WARN_LOCK")


def _warn_once(path: str, reason: str, detail: str) -> None:
    with _WARN_LOCK:
        if (path, reason) in _WARNED:
            return
        _WARNED.add((path, reason))
    warnings.warn(
        f"plan DB {path}: {detail} — continuing with no stored plans "
        "from this file (delete or re-tune to rebuild)",
        stacklevel=3,
    )


def platform_of(device=None) -> str:
    """The platform segment of the port's keys: ``torch-<device type>``
    of the resolved device (None: the card, and without CUDA the device
    rule's ``RuntimeError``)."""
    from dhqr_tpu_torch.utils.device import resolve_device

    return f"torch-{resolve_device(device).type}"


def plan_key(kind: str, m: int, n: int, dtype, nproc: int = 1,
             policy_tag: str = "-", platform: Optional[str] = None,
             device=None) -> str:
    """Render a tuning key. ``platform`` defaults to
    :func:`platform_of` ``(device)`` — plans are measurements of one
    program on one device, so a CPU-tuned winner must never shadow the
    card's entry for the same shape. With an explicit ``platform`` the
    string equals the JAX package's."""
    if platform is None:
        platform = platform_of(device)
    return (f"{platform}:{kind}:{int(m)}x{int(n)}:"
            f"{dtype_name(dtype)}:p{int(nproc)}:{policy_tag or '-'}")


def policy_tag(pol) -> str:
    """Canonical tag for the policy component of a key ("-" = no policy).
    Tags the RESOLVED precision tuple, not the preset name, so two
    spellings of the same tuple share their tuned plans. A comms wire
    format (dhqr-wire, round 18) appends a ``/w<mode>`` segment — only
    when set, so every pre-round-18 key (and the shipped seed DB)
    keeps matching."""
    if pol is None:
        return "-"
    return (f"{pol.panel}/{pol.trailing or '-'}/"
            f"{pol.apply or '-'}/r{pol.refine}"
            + (f"/w{pol.comms}" if getattr(pol, "comms", None) else ""))


def _check_entry(entry: dict) -> Plan:
    """Validate one DB entry payload; raises on any malformation."""
    if not isinstance(entry, dict):
        raise ValueError(f"entry must be a dict, got {type(entry)}")
    return Plan.from_dict(entry["plan"])


class PlanDB:
    """In-memory view of one plan-DB file (plus optional read-only seeds).

    ``entries`` maps key-string -> entry dict (``{"plan": {...}, ...
    metadata}``). Thread-safe for the get/record/save surface.
    """

    def __init__(self, path: "str | None" = None,
                 seed_path: "str | None" = None) -> None:
        self.path = path
        self._lock = _lockwitness.make_rlock("PlanDB._lock")
        self.entries: "dict[str, dict]" = {}   # guarded by: _lock
        self._seeds: "dict[str, dict]" = {}    # guarded by: frozen
        if seed_path:
            self._seeds = self._load_file(seed_path)
        if path:
            self.entries = self._load_file(path)

    # -- loading -----------------------------------------------------------
    @staticmethod
    def _load_file(path: str) -> "dict[str, dict]":
        """Tolerantly read one DB file into a key->entry dict."""
        if not os.path.exists(path):
            return {}
        try:
            with open(path, "r", encoding="utf-8") as fh:
                raw = json.load(fh)
        except (OSError, ValueError) as e:
            _warn_once(path, "corrupt", f"unreadable ({type(e).__name__}: {e})")
            return {}
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA:
            _warn_once(path, "schema",
                       "not a dhqr plan database (missing/foreign schema tag)")
            return {}
        if raw.get("version") != SCHEMA_VERSION:
            _warn_once(path, "version",
                       f"schema version {raw.get('version')!r} != "
                       f"{SCHEMA_VERSION} (stale or future file)")
            return {}
        plans = raw.get("plans")
        if not isinstance(plans, dict):
            _warn_once(path, "plans", "'plans' is not an object")
            return {}
        out = {}
        for key, entry in plans.items():
            try:
                _check_entry(entry)
            except Exception as e:
                _warn_once(path, f"entry:{key}",
                           f"dropping malformed entry {key!r} "
                           f"({type(e).__name__}: {e})")
                continue
            out[str(key)] = entry
        return out

    # -- read --------------------------------------------------------------
    def get(self, key: str) -> "Plan | None":
        """The stored plan for ``key`` (local entries shadow seeds)."""
        entry = self.get_entry(key)
        return None if entry is None else Plan.from_dict(entry["plan"])

    def get_entry(self, key: str) -> "dict | None":
        with self._lock:
            entry = self.entries.get(key)
            if entry is None:
                entry = self._seeds.get(key)
            return None if entry is None else dict(entry)

    def __len__(self) -> int:
        with self._lock:
            return len(self.entries)

    def keys(self) -> "list[str]":
        """Local + seed keys (local shadowing), sorted for determinism."""
        with self._lock:
            return sorted(set(self._seeds) | set(self.entries))

    # -- write -------------------------------------------------------------
    def record(self, key: str, plan: Plan, **meta) -> dict:
        """Store a winner in memory (``save()`` persists). ``meta`` is
        free-form measurement metadata (speedup, seconds, source...)."""
        if not isinstance(plan, Plan):
            raise ValueError(
                f"record() takes a Plan, got {type(plan).__name__}"
            )
        entry = {"plan": plan.to_dict(), **meta}
        _check_entry(entry)  # never record what load() would drop
        with self._lock:
            self.entries[key] = entry
        return entry

    def forget(self, key: str) -> bool:
        """Drop a (possibly poisoned) local entry; True if it existed."""
        with self._lock:
            return self.entries.pop(key, None) is not None

    @staticmethod
    @contextlib.contextmanager
    def _file_lock(path: str):
        """Advisory inter-process lock for the read-merge-replace window.

        Without it, two savers that both read the pre-state before
        either replaces the file would silently drop each other's
        DISJOINT keys (last-write-wins is for contended keys only).
        flock is advisory and POSIX-only; where unavailable the save
        degrades to the unlocked race rather than failing.
        """
        try:
            import fcntl
        except ImportError:  # non-POSIX: keep working, racy
            yield
            return
        fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            # The witness sees the flock window as a lock-like region,
            # so a threading acquisition inside it records an edge.
            with _lockwitness.witness_region("PlanDB._file_lock"):
                yield
        finally:
            os.close(fd)  # closing releases the flock

    def save(self, path: "str | None" = None) -> str:
        """Merge-write the local entries to disk (last-write-wins).

        Re-reads the destination first so concurrent writers UNION their
        keys (this process's entries win contended keys — it is the
        later writer), then replaces the file atomically. The
        read-merge-replace window holds an advisory file lock so a
        concurrent saver cannot lose this one's keys.
        """
        path = path or self.path
        if not path:
            raise ValueError("no path: pass save(path) or construct "
                             "PlanDB(path=...)")
        with self._lock:
            ours = {k: dict(v) for k, v in self.entries.items()}
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        with self._file_lock(path):
            merged = self._load_file(path)
            merged.update(ours)
            payload = {"schema": SCHEMA, "version": SCHEMA_VERSION,
                       "plans": {k: merged[k] for k in sorted(merged)}}
            fd, tmp = tempfile.mkstemp(prefix=".plandb-", dir=directory)
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as fh:
                    json.dump(payload, fh, indent=1, sort_keys=True)
                    fh.write("\n")
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                # dhqr: ignore[DHQR006] best-effort temp-file cleanup on the error path; the original exception reraises below
                except OSError:
                    pass
                raise
        with self._lock:
            self.entries = merged
        return path


# -- process default -------------------------------------------------------
_DEFAULT_DB: "PlanDB | None" = None
_DEFAULT_DB_LOCK = _lockwitness.make_lock("db._DEFAULT_DB_LOCK")


def default_db() -> PlanDB:
    """The process-default plan DB: ``TuneConfig.db_path``
    (``DHQR_TUNE_DB``) layered over the shipped seeds. Created lazily on
    first use, like the serve cache."""
    global _DEFAULT_DB
    if _DEFAULT_DB is None:
        with _DEFAULT_DB_LOCK:
            if _DEFAULT_DB is None:
                from dhqr_tpu_torch.utils.config import TuneConfig

                cfg = TuneConfig.from_env()
                _DEFAULT_DB = PlanDB(
                    cfg.db_path,
                    seed_path=SEED_PATH if cfg.use_seeds else None)
    return _DEFAULT_DB


def reset_default_db() -> None:
    """Drop the cached process-default DB (tests; or after changing
    ``DHQR_TUNE_DB``) — the next ``default_db()`` re-reads the env."""
    global _DEFAULT_DB
    with _DEFAULT_DB_LOCK:
        _DEFAULT_DB = None
