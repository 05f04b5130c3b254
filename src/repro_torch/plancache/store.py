"""On-disk plan store: content-hashed entries, atomic writes, typed
corruption recovery.

Layout — one JSON file per entry, flat in the store root::

    <root>/<kind>-<family digest[:16]>-<key digest[:24]>.json

``kind`` is the cache namespace (``solve`` / ``s2``), the *key* digest
hashes the full canonical key (spec + p + hardware + every search knob,
defaults applied), and the *family* digest hashes the key minus the
scenario axes that sweeps vary (``p`` and ``hw.size_mem``) — so the
same-family glob enumerates exactly the nearest-scenario warm-start
candidates for a new budget point.

Durability rules:

* **Atomic writes** — payloads land in a temp file in the store root and
  are ``os.replace``d into place, so concurrent writers race benignly
  (readers only ever see a complete file; the last complete write wins).
* **Versioned schema** — every payload records ``SCHEMA_VERSION``; an
  entry from another version raises :class:`CacheSchemaError` and is
  evicted (stale), never decoded.
* **Typed corruption recovery** — unparseable JSON, missing fields, or a
  payload the decoder rejects raise :class:`CacheCorruptionError`.
  :meth:`PlanStore.get` converts either error into an eviction plus a
  miss, so the caller transparently re-solves; a damaged cache can cost
  time, never correctness.

Counters (hits / misses / writes / evictions / corruptions / stale /
warm adoption) are kept per store instance and mirrored into the
``repro_torch.obs.metrics`` registry under ``plancache/``.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Callable

#: Bump when the payload layout or the codec's serialization changes:
#: every existing entry becomes stale and is evicted on first touch.
SCHEMA_VERSION = 1

#: Env var holding the store root directory; unset/empty disables the
#: persistent layer entirely (the default — in-memory LRUs only).
ENV_VAR = "REPRO_PLAN_CACHE"


class PlanCacheError(Exception):
    """Base class for persistent-plan-cache errors."""


class CacheCorruptionError(PlanCacheError):
    """A cache entry that cannot be trusted: unparseable JSON, a missing
    field, or a payload the decoder rejects.  Always handled by eviction
    + re-solve; never propagated out of :meth:`PlanStore.get`."""

    def __init__(self, message: str, path: str | None = None) -> None:
        super().__init__(message)
        self.path = path


class CacheSchemaError(CacheCorruptionError):
    """An entry written under a different ``SCHEMA_VERSION`` (stale)."""


def canonical_digest(obj: Any) -> str:
    """sha256 of the canonical JSON encoding (sorted keys, no spaces) —
    the content hash used for entry file names."""
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


class PlanStore:
    """One store root; see the module note for layout and durability."""

    def __init__(self, root: "str | os.PathLike[str]") -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.writes = 0
        self.evictions = 0          # corrupt + stale, total files removed
        self.corruptions = 0
        self.stale = 0
        self.warm_considered = 0    # neighbour candidates repriced
        self.warm_adopted = 0       # ... that beat the cold search

    # -- paths --------------------------------------------------------- #

    def entry_path(self, kind: str, family_digest: str,
                   key_digest: str) -> Path:
        return self.root / f"{kind}-{family_digest[:16]}-{key_digest[:24]}.json"

    # -- low level ----------------------------------------------------- #

    def load_entry(self, path: "str | Path") -> dict:
        """Parse and structurally validate one entry file.

        Raises :class:`CacheSchemaError` for entries from another schema
        version and :class:`CacheCorruptionError` for anything else that
        cannot be trusted — the typed half of corruption recovery; the
        transparent half (evict + re-solve) lives in :meth:`get`."""
        try:
            with open(path, "r", encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CacheCorruptionError(
                f"unreadable cache entry {path}: {e}", path=str(path)) from e
        if not isinstance(payload, dict):
            raise CacheCorruptionError(
                f"cache entry {path} is not an object", path=str(path))
        schema = payload.get("schema")
        if schema != SCHEMA_VERSION:
            raise CacheSchemaError(
                f"cache entry {path} has schema {schema!r}, "
                f"expected {SCHEMA_VERSION}", path=str(path))
        if "key" not in payload or "result" not in payload:
            raise CacheCorruptionError(
                f"cache entry {path} is missing key/result fields",
                path=str(path))
        return payload

    def _evict(self, path: Path, *, stale: bool = False) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass
        self.evictions += 1
        _metric("evictions")
        if stale:
            self.stale += 1
            _metric("stale")
        else:
            self.corruptions += 1
            _metric("corruptions")

    # -- public API ---------------------------------------------------- #

    def get(self, kind: str, key: dict, family_digest: str,
            decode: Callable[[dict], Any]) -> Any | None:
        """Exact-key lookup.  ``decode`` turns the stored ``result`` dict
        into the caller's object; any :class:`CacheCorruptionError` it
        (or the file layer) raises evicts the entry and returns None —
        the caller re-solves, never crashes on a bad entry."""
        path = self.entry_path(kind, family_digest, canonical_digest(key))
        if not path.exists():
            self.misses += 1
            _metric("misses")
            return None
        try:
            payload = self.load_entry(path)
            if payload["key"] != key:          # digest-prefix collision
                raise CacheCorruptionError(
                    f"cache entry {path} holds a different key",
                    path=str(path))
            value = decode(payload["result"])
        except CacheSchemaError:
            self._evict(path, stale=True)
            self.misses += 1
            _metric("misses")
            return None
        except CacheCorruptionError:
            self._evict(path)
            self.misses += 1
            _metric("misses")
            return None
        self.hits += 1
        _metric("hits")
        return value

    def put(self, kind: str, key: dict, family_digest: str,
            result: dict) -> None:
        """Atomic write (tmp file + ``os.replace``).  A failed write is
        dropped silently — the persistent layer is an accelerator, never
        a correctness dependency."""
        path = self.entry_path(kind, family_digest, canonical_digest(key))
        payload = {"schema": SCHEMA_VERSION, "kind": kind,
                   "key": key, "result": result}
        data = json.dumps(payload, sort_keys=True)
        try:
            fd, tmp = tempfile.mkstemp(
                dir=self.root, prefix=f".{kind}-", suffix=".tmp")
        except OSError:
            return
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self.writes += 1
        _metric("writes")

    def neighbors(self, kind: str, family_digest: str, *,
                  exclude_key: dict | None = None,
                  limit: int = 32) -> list[tuple[dict, dict]]:
        """Same-family entries (same spec + knobs; budget/``p`` differ):
        the nearest-scenario warm-start candidates.  Corrupt/stale
        siblings are evicted on the way.  Returns ``(key, result)`` raw
        dicts; the caller decodes, sorts by scenario distance and
        reprices."""
        skip = None
        if exclude_key is not None:
            skip = self.entry_path(
                kind, family_digest, canonical_digest(exclude_key)).name
        out: list[tuple[dict, dict]] = []
        for path in sorted(self.root.glob(
                f"{kind}-{family_digest[:16]}-*.json")):
            if path.name == skip:
                continue
            try:
                payload = self.load_entry(path)
            except CacheSchemaError:
                self._evict(path, stale=True)
                continue
            except CacheCorruptionError:
                self._evict(path)
                continue
            out.append((payload["key"], payload["result"]))
            if len(out) >= limit:
                break
        return out

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("*.json"))

    def stats(self) -> dict:
        return {
            "root": str(self.root),
            "entries": len(self),
            "hits": self.hits,
            "misses": self.misses,
            "writes": self.writes,
            "evictions": self.evictions,
            "corruptions": self.corruptions,
            "stale": self.stale,
            "warm_considered": self.warm_considered,
            "warm_adopted": self.warm_adopted,
        }


def _metric(name: str, amount: "int | float" = 1) -> None:
    # lazy import: keep the store importable without pulling repro_torch.obs in
    # contexts that only want the file layer
    from repro_torch.obs.metrics import REGISTRY
    REGISTRY.incr(f"plancache/{name}", amount)


_active: PlanStore | None = None
_active_root: str | None = None


def active_store() -> PlanStore | None:
    """The process-wide store, governed by ``REPRO_PLAN_CACHE`` (a
    directory; unset/empty = disabled).  The env var is re-read on every
    call so tests and the plan server can flip it; the ``PlanStore``
    object (and its counters) is cached per root string.  An unusable
    root (e.g. mkdir denied) disables the layer instead of failing the
    solve."""
    global _active, _active_root
    root = os.environ.get(ENV_VAR) or None
    if root != _active_root:
        try:
            _active = PlanStore(root) if root else None
        except OSError:
            _active = None
        _active_root = root
    return _active


def configure(root: "str | os.PathLike[str] | None") -> PlanStore | None:
    """Programmatic enable/disable: sets/clears ``REPRO_PLAN_CACHE`` so
    ``active_store()`` (and any child tooling reading the env) agree."""
    if root is None:
        os.environ.pop(ENV_VAR, None)
    else:
        os.environ[ENV_VAR] = os.fspath(root)
    return active_store()


def reset() -> None:
    """Drop the cached ``PlanStore`` object (counters included) so the
    next ``active_store()`` call rebuilds it from the env — the
    in-process stand-in for a process restart in the persistence
    tests."""
    global _active, _active_root
    _active = None
    _active_root = None
