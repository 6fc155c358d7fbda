"""Disk-backed, size-bounded artifact store (the ISA-Mapper measurement-
database pattern, keyed like the in-process compile cache).

One JSON file per content-addressed key.  An entry does NOT pickle the
scheduled codelet — it serialises the *schedule decisions* (tiling +
unroll factor + pack), the analytic cost report(s), the pass notes and the
search digest.  A warm hit therefore restores a ``CompiledArtifact`` whose
analytics (``cycles()`` / ``report()``) work with **zero pipeline stage
executions**; the scheduled codelet and mnemonic program are rebuilt
lazily — only if ``.program`` / ``.run()`` is actually touched — by
replaying the pipeline with the stored decisions injected as pass inputs
(no tiling enumeration, no search re-run).

Robustness contract (tests/test_store.py):
* corrupt / truncated / wrong-format entries read as a miss, the bad file
  is deleted, and the caller recompiles cleanly;
* the store is size-bounded: writes evict least-recently-used entries
  (mtime order; loads bump recency) until under ``max_bytes``;
* ``clear()`` (surfaced as ``repro_torch.clear_cache(disk=True)``) empties it.

Activate per-compile with ``CompileOptions(store=ArtifactStore(dir))`` (or
``store="dir"``), or process-wide with the ``REPRO_TORCH_CACHE_DIR``
environment variable — that is what makes multi-process sweeps replay
warm.

Multi-writer contract (a sweep coordinator, the reference's
``core/sweep.py``, runs fleets of worker processes over one store):

* a single put is atomic (tmp + ``os.replace``) and is never evicted by
  the writing process itself;
* LRU eviction is serialised by a store-wide ``FileLock`` and never
  touches a *foreign* entry younger than ``FRESH_GRACE`` seconds, so two
  concurrently-evicting processes cannot delete each other's fresh puts;
* sweep workers claim work units through per-entry claim files
  (``claim()`` / ``release_claim()``) with a stale-claim timeout, so a
  crashed worker's units are reclaimed instead of lost;
* every compile a sweep performs is recorded in a monotonic, append-only
  ``SweepJournal`` (one JSON line per event, sequence numbers issued
  under the lock) — CI asserts "each work unit compiled exactly once"
  straight off the journal;
* ``gc()`` reclaims by age and size and reaps orphaned tmp/lock/claim
  files.

The port's copy of ``repro.core.store``, with the same logic and its own
environment variables: ``REPRO_TORCH_CACHE_DIR`` and
``REPRO_TORCH_CACHE_MAX_MB``, never the reference's ``REPRO_CACHE_DIR``.
A store key covers only the compile's inputs, so the port's entries take
the reference's keys; ``compiler_signature`` hashes each compiler's own
source, so each reads the other's entries as stale and deletes them.  In
one shared directory the two compilers would evict each other's entries.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time as _time

FORMAT = 1
ENV_DIR = "REPRO_TORCH_CACHE_DIR"
ENV_MAX_MB = "REPRO_TORCH_CACHE_MAX_MB"
_SUFFIX = ".json"
# eviction never deletes another process's entry younger than this (s):
# between a foreign put and that process's first warm read there must be
# no window in which our own LRU scan can reap it
FRESH_GRACE = 30.0
_SWEEP_PREFIX = "sweep-"


def compiler_signature() -> str:
    """Digest of the stock compiler's source (pipeline stages, scheduler,
    passes, cost model, codegen).  Stamped into every store entry and
    checked on load, so a persistent REPRO_TORCH_CACHE_DIR can never serve
    schedules or cycle counts produced by a *different* compiler — the
    content-addressed key only covers inputs, not the compiler itself."""
    global _SIGNATURE
    if _SIGNATURE is None:
        import hashlib
        import inspect

        from . import (codegen, cost, covenant, driver, passes, pipeline,
                       scheduler, search, spec)
        h = hashlib.sha256()
        for mod in (pipeline, scheduler, passes, cost, codegen, search,
                    driver, covenant, spec):
            try:
                h.update(inspect.getsource(mod).encode())
            except (OSError, TypeError):
                h.update(mod.__name__.encode())
        _SIGNATURE = h.hexdigest()[:16]
    return _SIGNATURE


_SIGNATURE: str | None = None


def _break_stale(path: str) -> bool:
    """Remove a stale lock/claim file *atomically claimed for removal*:
    rename-to-unique first, so of two breakers exactly one wins and
    neither can ever delete the file a third process just re-created
    under the original name (the stat-then-remove TOCTOU)."""
    tomb = f"{path}.stale-{os.getpid()}-{_time.monotonic_ns()}"
    try:
        os.rename(path, tomb)
    except OSError:
        return False  # someone else broke (or released) it first
    try:
        os.remove(tomb)
    except OSError:
        pass
    return True


class FileLock:
    """Cross-process advisory lock: an ``O_CREAT|O_EXCL`` lock file.

    A holder that dies leaves the file behind; any later acquirer breaks
    the lock once it is older than ``stale_timeout`` seconds — liveness
    over strictness, the right trade for a measurement cache (the guarded
    operations are idempotent or re-checkable).  Use as a context manager
    (raises ``TimeoutError``) or via ``acquire(timeout=0)`` for a
    non-blocking attempt.
    """

    def __init__(self, path: str, stale_timeout: float = 60.0):
        self.path = path
        self.stale_timeout = stale_timeout
        self._held = False

    def acquire(self, timeout: float = 10.0) -> bool:
        deadline = _time.monotonic() + timeout
        while True:
            try:
                fd = os.open(self.path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                try:
                    age = _time.time() - os.stat(self.path).st_mtime
                except OSError:
                    continue  # holder released between open and stat: retry
                if age > self.stale_timeout:
                    _break_stale(self.path)  # losers just retry O_EXCL
                    continue
                if _time.monotonic() >= deadline:
                    return False
                _time.sleep(0.01)
                continue
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(json.dumps({"pid": os.getpid(),
                                    "time": _time.time()}))
            self._held = True
            return True

    def release(self) -> None:
        if self._held:
            self._held = False
            try:
                os.remove(self.path)
            except OSError:
                pass

    def __enter__(self) -> "FileLock":
        if not self.acquire():
            raise TimeoutError(f"could not acquire lock {self.path!r}")
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class SweepJournal:
    """Monotonic, append-only event log of one sweep over a store.

    One JSON object per line in ``<root>/sweep-<id>/journal.jsonl``; each
    ``append`` is issued a strictly increasing ``seq`` under a
    ``FileLock``, so events from any number of worker processes totally
    order, and "each work unit compiled exactly once" is a pure journal
    query (``compile_counts``).  The journal survives warm re-runs of the
    same sweep id — a warm run that recompiles nothing appends only
    ``store_hit`` events, which is exactly what CI asserts.
    """

    def __init__(self, store: "ArtifactStore", sweep_id: str):
        self.store = store
        self.sweep_id = sweep_id
        self.dir = store.sweep_dir(sweep_id)
        self.path = os.path.join(self.dir, "journal.jsonl")
        self._seq_path = os.path.join(self.dir, "journal.seq")
        # the lock is held for one tiny read+append: a holder that lives
        # 10s is dead, and the 30s acquire window below always outlasts
        # the stale threshold, so a crashed holder can delay appends but
        # never wedge the fleet
        self._lock = FileLock(os.path.join(self.dir, "journal.lock"),
                              stale_timeout=10.0)

    def append(self, record: dict) -> int:
        """Write ``record`` (plus ``seq``/``time``/``sweep``) as one line;
        returns the issued sequence number."""
        if not self._lock.acquire(timeout=30.0):
            raise TimeoutError(
                f"could not acquire journal lock {self._lock.path!r}")
        try:
            try:
                with open(self._seq_path, "r", encoding="utf-8") as f:
                    seq = int(f.read().strip() or 0)
            except (OSError, ValueError):
                seq = 0
            seq += 1
            line = json.dumps(dict(record, seq=seq, sweep=self.sweep_id,
                                   time=_time.time()))
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
            tmp = f"{self._seq_path}.{os.getpid()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(str(seq))
            os.replace(tmp, self._seq_path)
        finally:
            self._lock.release()
        return seq

    def read(self) -> list[dict]:
        """All events, in seq order; unreadable lines (a writer died mid-
        line) are skipped."""
        out = []
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except FileNotFoundError:
            return []
        out.sort(key=lambda r: r.get("seq", 0))
        return out

    def compile_counts(self) -> dict:
        """{key: number of 'compiled' events} — the exactly-once check."""
        counts: dict[str, int] = {}
        for rec in self.read():
            if rec.get("event") == "compiled":
                k = rec.get("key", "?")
                counts[k] = counts.get(k, 0) + 1
        return counts


class ArtifactStore:
    """Content-addressed key -> schedule-decision entry, on disk."""

    def __init__(self, root: str, max_bytes: int | None = None):
        self.root = os.path.abspath(os.path.expanduser(os.fspath(root)))
        if max_bytes is None:
            max_bytes = int(float(os.environ.get(ENV_MAX_MB, 256)) * 2 ** 20)
        self.max_bytes = max_bytes
        os.makedirs(self.root, exist_ok=True)
        self.stats = {"hits": 0, "misses": 0, "puts": 0, "evictions": 0,
                      "corrupt": 0, "stale": 0, "claims": 0, "reclaims": 0,
                      "claim_losses": 0}
        # entry paths THIS process wrote: eviction may reap our own fresh
        # entries (the size bound is ours to keep) but never a foreign
        # entry younger than FRESH_GRACE — see the multi-writer contract
        self._own: set[str] = set()
        # running size estimate: puts add to it, the (O(entries)) eviction
        # scan only runs once it crosses max_bytes, then re-measures
        self._approx_bytes = self.size_bytes()

    # -- paths ---------------------------------------------------------------
    def _path(self, key: str) -> str:
        assert key and all(c in "0123456789abcdef" for c in key), key
        return os.path.join(self.root, key + _SUFFIX)

    def _entries(self) -> list[str]:
        return self._listdir(_SUFFIX)

    def _tmp_files(self) -> list[str]:
        return self._listdir(".tmp")

    def _listdir(self, suffix: str) -> list[str]:
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        return [os.path.join(self.root, n) for n in names
                if n.endswith(suffix)]

    # -- core ops ------------------------------------------------------------
    def load(self, key: str) -> dict | None:
        """The stored entry for ``key``, or None (miss).  Anything
        unreadable — truncated JSON, foreign schema, key mismatch — is
        treated as a miss and the offending file is removed."""
        path = self._path(key)
        try:
            with open(path, "r", encoding="utf-8") as f:
                entry = json.load(f)
            if not isinstance(entry, dict) or entry.get("format") != FORMAT \
                    or entry.get("key") != key or "reports" not in entry:
                raise ValueError("foreign or incomplete entry")
        except FileNotFoundError:
            self.stats["misses"] += 1
            return None
        except Exception:
            self.stats["corrupt"] += 1
            self.stats["misses"] += 1
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        if entry.get("compiler") != compiler_signature():
            # produced by a different compiler version: the schedule and
            # cycle counts may no longer be what this compiler would emit
            self.stats["stale"] += 1
            self.stats["misses"] += 1
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        try:
            os.utime(path, None)  # bump LRU recency
        except OSError:
            pass
        self.stats["hits"] += 1
        return entry

    def put(self, key: str, entry: dict) -> None:
        entry = dict(entry, format=FORMAT, key=key,
                     compiler=compiler_signature())
        path = self._path(key)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(entry, f)
            os.replace(tmp, path)  # atomic vs concurrent readers
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        self.stats["puts"] += 1
        self._own.add(path)
        try:
            self._approx_bytes += os.stat(path).st_size
        except OSError:
            pass
        if self._approx_bytes > self.max_bytes:
            self._evict(keep=path)

    def invalidate(self, key: str) -> None:
        """Forget an entry that loaded but could not be restored: delete
        the file and reclassify the load as a corrupt miss."""
        try:
            os.remove(self._path(key))
        except OSError:
            pass
        self.stats["hits"] -= 1
        self.stats["misses"] += 1
        self.stats["corrupt"] += 1

    def _evict_lock(self) -> FileLock:
        return FileLock(os.path.join(self.root, ".evict.lock"))

    def _evict(self, keep: str | None = None,
               max_bytes: int | None = None) -> None:
        """Drop least-recently-used entries until under ``max_bytes``;
        ``keep`` (the just-written path) is never a victim, even under
        mtime ties on coarse-timestamp filesystems, so a put always
        sticks.  Also reaps stale ``.tmp`` leftovers of interrupted puts —
        they are invisible to loads, so without this they would
        accumulate unbounded.

        Concurrency: the scan runs under a non-blocking store-wide lock —
        if another process is already evicting, we simply skip (the bound
        is approximate; the next put retries) — and *foreign* entries
        younger than ``FRESH_GRACE`` are never victims, so two processes
        evicting around the same time cannot reap each other's fresh
        puts before their writers ever read them back."""
        lock = self._evict_lock()
        if not lock.acquire(timeout=0):
            return
        try:
            budget = self.max_bytes if max_bytes is None else max_bytes
            now = _time.time()
            for p in self._tmp_files():
                try:
                    if now - os.stat(p).st_mtime > 600:
                        os.remove(p)
                except OSError:
                    pass
            files = []
            for p in self._entries():
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                files.append((st.st_mtime, st.st_size, p))
            files.sort()
            total = sum(sz for _, sz, _ in files)
            if keep is None and files:
                keep = files[-1][2]  # protect the most recent entry
            victims = [f for f in files if f[2] != keep
                       and (f[2] in self._own
                            or now - f[0] > FRESH_GRACE)]
            while victims and total > budget:
                _, sz, victim = victims.pop(0)
                try:
                    os.remove(victim)
                except OSError:
                    continue
                self._own.discard(victim)
                total -= sz
                self.stats["evictions"] += 1
            self._approx_bytes = total
        finally:
            lock.release()

    def peek(self, key: str) -> dict | None:
        """Read an entry without touching stats, recency or the file
        itself — the sweep coordinator's dedup probe.  Any unreadable or
        foreign entry is simply ``None`` (the eventual ``load`` will
        classify and clean it)."""
        try:
            with open(self._path(key), "r", encoding="utf-8") as f:
                entry = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(entry, dict) or entry.get("format") != FORMAT \
                or entry.get("key") != key or "reports" not in entry \
                or entry.get("compiler") != compiler_signature():
            return None
        return entry

    def clear(self) -> None:
        import shutil
        for p in self._entries() + self._tmp_files():
            try:
                os.remove(p)
            except OSError:
                pass
        for d in self.sweep_dirs():
            shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(os.path.join(self.root, "pins"), ignore_errors=True)
        self._approx_bytes = 0

    # -- sweep coordination (claims + journals) ------------------------------
    def sweep_dir(self, sweep_id: str, create: bool = True) -> str:
        """Scratch directory of one sweep (claims, journal) under the
        store root — shared state travels with the measurement database."""
        assert sweep_id and "/" not in sweep_id and ".." not in sweep_id, \
            sweep_id
        d = os.path.join(self.root, _SWEEP_PREFIX + sweep_id)
        if create:
            os.makedirs(d, exist_ok=True)
        return d

    def sweep_dirs(self) -> list[str]:
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        return [os.path.join(self.root, n) for n in names
                if n.startswith(_SWEEP_PREFIX)
                and os.path.isdir(os.path.join(self.root, n))]

    def journal(self, sweep_id: str) -> SweepJournal:
        return SweepJournal(self, sweep_id)

    def _claim_path(self, sweep_id: str, key: str) -> str:
        return os.path.join(self.sweep_dir(sweep_id), key + ".claim")

    def claim(self, sweep_id: str, key: str, owner: str,
              stale_timeout: float = 60.0) -> bool:
        """Try to claim work unit ``key`` of ``sweep_id`` for ``owner``.

        Exactly one live claimer wins (``O_CREAT|O_EXCL``).  A claim left
        behind by a crashed worker is broken once older than
        ``stale_timeout`` seconds, so its units are *reclaimed* — the
        sweep always drains."""
        path = self._claim_path(sweep_id, key)
        reclaimed = False
        while True:
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                try:
                    age = _time.time() - os.stat(path).st_mtime
                except OSError:
                    continue  # released under us: retry the O_EXCL attempt
                if age > stale_timeout:
                    # break the dead worker's claim; _break_stale's atomic
                    # rename guarantees a racing breaker can never delete
                    # a claim some third worker just re-won
                    reclaimed = _break_stale(path) or reclaimed
                    continue
                self.stats["claim_losses"] += 1
                return False
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(json.dumps({"owner": owner, "pid": os.getpid(),
                                    "time": _time.time()}))
            self.stats["claims"] += 1
            if reclaimed:
                self.stats["reclaims"] += 1
            return True

    def release_claim(self, sweep_id: str, key: str, owner: str) -> None:
        """Drop ``owner``'s claim.  A claim re-issued to someone else
        after ours went stale is left alone."""
        path = self._claim_path(sweep_id, key)
        try:
            with open(path, "r", encoding="utf-8") as f:
                if json.load(f).get("owner") != owner:
                    return
        except (OSError, ValueError):
            return
        try:
            os.remove(path)
        except OSError:
            pass

    def gc(self, max_age: float | None = None,
           max_bytes: int | None = None,
           claim_timeout: float = 3600.0) -> dict:
        """Reclaim disk: drop entries older than ``max_age`` seconds, then
        LRU-evict down to ``max_bytes`` (default: the store's own bound),
        and reap orphaned ``.tmp`` files, stale claim files and sweep
        scratch dirs older than ``max_age``.  Returns counts."""
        import shutil
        now = _time.time()
        out = {"aged": 0, "evicted": 0, "claims_reaped": 0,
               "sweeps_reaped": 0}
        if max_age is not None:
            for p in self._entries():
                try:
                    if now - os.stat(p).st_mtime > max_age:
                        os.remove(p)
                        self._own.discard(p)
                        out["aged"] += 1
                except OSError:
                    pass
        for d in self.sweep_dirs():
            try:
                if max_age is not None \
                        and now - os.stat(d).st_mtime > max_age:
                    shutil.rmtree(d, ignore_errors=True)
                    out["sweeps_reaped"] += 1
                    continue
            except OSError:
                continue
            for n in os.listdir(d):
                if not n.endswith(".claim"):
                    continue
                p = os.path.join(d, n)
                try:
                    if now - os.stat(p).st_mtime > claim_timeout:
                        os.remove(p)
                        out["claims_reaped"] += 1
                except OSError:
                    pass
        before = self.stats["evictions"]
        self._evict(max_bytes=max_bytes)
        out["evicted"] = self.stats["evictions"] - before
        self._approx_bytes = self.size_bytes()
        return out

    # -- race pins -----------------------------------------------------------
    def _pin_dir(self, create: bool = True) -> str:
        d = os.path.join(self.root, "pins")
        if create:
            os.makedirs(d, exist_ok=True)
        return d

    @staticmethod
    def pin_name(layer: str, target: str) -> str:
        raw = f"{layer}@{target}"
        return "".join(c if c.isalnum() or c in "@=-_.,x" else "_"
                       for c in raw)

    def pin(self, name: str, record: dict) -> None:
        """Atomically record a race winner (or any named best-point
        digest) under ``<root>/pins/<name>.json`` — the ``searches=``
        racing sweep pins each (layer, target)'s winning strategy/point
        here, and the warm-start index treats pins as prime seeds."""
        path = os.path.join(self._pin_dir(), name + _SUFFIX)
        fd, tmp = tempfile.mkstemp(dir=self._pin_dir(), suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(dict(record, pin=name, time=_time.time()), f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def load_pin(self, name: str) -> dict | None:
        try:
            with open(os.path.join(self._pin_dir(create=False),
                                   name + _SUFFIX),
                      "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def pins(self) -> dict[str, dict]:
        """{pin name: record} of every readable pin."""
        out = {}
        try:
            names = os.listdir(self._pin_dir(create=False))
        except FileNotFoundError:
            return out
        for n in sorted(names):
            if not n.endswith(_SUFFIX):
                continue
            rec = self.load_pin(n[:-len(_SUFFIX)])
            if rec is not None:
                out[n[:-len(_SUFFIX)]] = rec
        return out

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries())

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def keys(self) -> list[str]:
        return [os.path.basename(p)[:-len(_SUFFIX)] for p in self._entries()]

    def size_bytes(self) -> int:
        total = 0
        for p in self._entries():
            try:
                total += os.stat(p).st_size
            except OSError:
                pass
        return total

    def __repr__(self) -> str:
        return (f"ArtifactStore({self.root!r}, entries={len(self)}, "
                f"bytes={self.size_bytes()}/{self.max_bytes})")


# ---------------------------------------------------------------------------
# warm-start index — cross-layer schedule-point transfer
# ---------------------------------------------------------------------------


class WarmStartIndex:
    """Best recorded schedule points, grouped by ``ScheduleSpace``
    signature — the cross-layer warm-start substrate.

    Built from the store's sweep journals (every (layer, variant, cycles)
    point a fleet ever measured) joined with the stored entries that
    carry the actual tiling/unroll decisions, plus race pins.  Searching
    a new layer asks ``seeds(space, ...)``: points from layers whose
    schedule space has the *same shape* (equal ``space.signature()``)
    transfer verbatim; points without a recorded signature are admitted
    only if they are valid schedule points of the requesting space.
    """

    def __init__(self):
        # (cycles, tie, sig | None, tiling, unroll) — tie keeps sort total
        self._points: list[tuple] = []

    def add(self, cycles: float, sig: str | None, tiling: dict,
            unroll: int, tie: str = "") -> None:
        self._points.append((float(cycles), str(tie), sig,
                             {str(k): int(v) for k, v in tiling.items()},
                             int(unroll)))

    def __len__(self) -> int:
        return len(self._points)

    @classmethod
    def from_store(cls, store: "ArtifactStore",
                   max_entries: int = 1024) -> "WarmStartIndex":
        idx = cls()
        if store is None:
            return idx
        # journal-first: sweep journals name the keys worth reading (and
        # carry cycles for events whose entries were since evicted).
        # Candidates are fully sorted (journalled best-cycles first, then
        # key) BEFORE the max_entries cap, so the same store contents
        # always build the same index regardless of directory-listing
        # order — the reproducibility contract warm-start documents.
        journalled: dict[str, float] = {}
        for d in sorted(store.sweep_dirs()):
            sweep_id = os.path.basename(d)[len(_SWEEP_PREFIX):]
            for rec in SweepJournal(store, sweep_id).read():
                k = rec.get("key")
                if isinstance(k, str) and rec.get("cycles") is not None:
                    cyc = float(rec["cycles"])
                    journalled[k] = min(journalled.get(k, cyc), cyc)
        unjournalled = sorted(set(store.keys()) - set(journalled))
        keys = sorted(journalled, key=lambda k: (journalled[k], k)) \
            + unjournalled
        for k in keys[:max_entries]:
            entry = store.peek(k)
            if entry is None or not entry.get("tiling"):
                continue
            cycles = entry_cycles(entry)
            if cycles is None:
                continue
            s = entry.get("search") or {}
            idx.add(cycles, s.get("space_sig"), entry["tiling"],
                    entry.get("unroll_factor", 1), tie=k)
        for name, rec in store.pins().items():
            point = rec.get("point") or {}
            if point.get("tiling") and rec.get("cycles") is not None:
                idx.add(rec["cycles"], rec.get("space_sig"),
                        point["tiling"], point.get("unroll_factor", 1),
                        tie=f"pin:{name}")
        return idx

    @classmethod
    def cached_for(cls, store: "ArtifactStore") -> "WarmStartIndex":
        """``from_store`` memoised on the store instance: rebuilding scans
        every journal and peeks up to 1024 entries, far too much to repeat
        per warm-started compile of a sweep.  The cache key is a cheap
        directory census (entry/sweep/pin counts + this process's puts —
        counting, never parsing, files), so foreign writers invalidate it
        as soon as their files land."""
        try:
            n_pins = sum(n.endswith(_SUFFIX)
                         for n in os.listdir(store._pin_dir(create=False)))
        except FileNotFoundError:
            n_pins = 0
        census = (store.stats["puts"], len(store), len(store.sweep_dirs()),
                  n_pins)
        cached = getattr(store, "_warm_index", None)
        if cached is not None and cached[0] == census:
            return cached[1]
        idx = cls.from_store(store)
        store._warm_index = (census, idx)
        return idx

    def seeds(self, space, unroll_choices=(1, 2, 4, 8),
              limit: int = 4) -> list[tuple[dict, int]]:
        """Up to ``limit`` (tiling, unroll) seed points for ``space``,
        best cycles first, exact signature matches before merely
        compatible points.  Every returned tiling is re-validated against
        the requesting space (Algorithm 1), so a stale or foreign record
        can never poison a search."""
        sig = space.signature()
        vars_ = set(space.divisors)
        unrolls = tuple(unroll_choices) or (1,)
        matches, compatible = [], []
        for cycles, tie, psig, tiling, unroll in sorted(
                self._points, key=lambda p: (p[0], p[1])):
            if set(tiling) != vars_ or not space.valid(tiling):
                continue
            u = unroll if unroll in unrolls \
                else min(unrolls, key=lambda c: (abs(c - unroll), c))
            (matches if psig == sig else compatible).append((tiling, u))
        out, seen = [], set()
        for tiling, u in matches + compatible:
            key = (tuple(sorted(tiling.items())), u)
            if key in seen:
                continue
            seen.add(key)
            out.append((tiling, u))
            if len(out) >= limit:
                break
        return out


# ---------------------------------------------------------------------------
# entry (de)serialisation helpers — used by the driver
# ---------------------------------------------------------------------------


def entry_from_artifact(art) -> dict:
    """Serialise a CompiledArtifact's schedule decisions + analytics.
    Forces the default-pack cost report so a warm restore can answer
    ``cycles()`` without running a single pass."""
    art.report()  # ensure at least the default-pack report is cached
    reports = {}
    for k, val in art.ctx.state.items():
        if isinstance(k, tuple) and len(k) == 2 and k[0] == "report":
            reports[str(int(bool(k[1])))] = dataclasses.asdict(val)
    # a store-restored artifact carries its decisions in ctx.overrides
    # (state only fills on lazy rebuild); fresh compiles record them in
    # ctx.state — prefer overrides so re-persisting never loses a
    # searched/injected schedule
    tiling = art.ctx.overrides.get("tiling", art.ctx.state.get("tiling"))
    unroll = art.ctx.overrides.get("unroll_factor",
                                   art.options.unroll_factor)
    entry = {
        "codelet": art.codelet.name,
        "target": art.target,
        "options": art.options.fingerprint(),
        "pack": bool(art._default_pack()),
        "tiling": dict(tiling) if tiling is not None else None,
        "unroll_factor": int(unroll),
        "notes": list(art.schedule_notes),
        "reports": reports,
    }
    if getattr(art, "search", None) is not None:
        entry["search"] = art.search.summary()
    return entry


def reports_from_entry(entry: dict) -> dict:
    """{pack(bool): CostReport} parsed from a stored entry."""
    from .cost import CostReport
    return {bool(int(k)): CostReport(**v)
            for k, v in entry["reports"].items()}


def default_store() -> "ArtifactStore | None":
    """The process-wide store named by ``REPRO_TORCH_CACHE_DIR``, if any.  An
    uncreatable directory disables the disk tier with a warning instead of
    failing every compile in the process (an *explicit*
    ``CompileOptions(store=...)`` still raises — the caller asked)."""
    path = os.environ.get(ENV_DIR)
    if not path:
        return None
    norm = os.path.abspath(os.path.expanduser(path))
    if norm in _BROKEN:
        return None
    try:
        return resolve(path)
    except OSError as e:
        import warnings
        _BROKEN.add(norm)
        warnings.warn(f"REPRO_TORCH_CACHE_DIR={path!r} is unusable ({e}); "
                      f"disk artifact store disabled for this process")
        return None


def resolve(store) -> "ArtifactStore | None":
    """ArtifactStore instance | directory path | None -> store (or the
    REPRO_TORCH_CACHE_DIR default, or None).  Path lookups are memoised so
    every compile against the same directory shares one stats-carrying object."""
    if store is None:
        return default_store() if os.environ.get(ENV_DIR) else None
    if isinstance(store, ArtifactStore):
        return store
    path = os.path.abspath(os.path.expanduser(os.fspath(store)))
    st = _DEFAULT.get(path)
    if st is None:
        st = _DEFAULT[path] = ArtifactStore(path)
    return st


_DEFAULT: dict[str, ArtifactStore] = {}
# REPRO_TORCH_CACHE_DIR paths that failed to initialise
_BROKEN: set[str] = set()


def entry_cycles(entry: dict) -> float | None:
    """The default-pack analytic cycle count recorded in a store entry —
    what the sweep coordinator reports for deduplicated work units
    without restoring (or even LRU-bumping) the artifact."""
    try:
        rep = entry["reports"][str(int(bool(entry["pack"])))]
        return float(rep["cycles"])
    except (KeyError, TypeError, ValueError):
        return None


__all__ = ["ArtifactStore", "ENV_DIR", "FORMAT", "FRESH_GRACE", "FileLock",
           "SweepJournal", "WarmStartIndex", "compiler_signature",
           "default_store", "entry_cycles", "entry_from_artifact",
           "reports_from_entry", "resolve"]
