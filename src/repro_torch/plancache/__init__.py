"""Persistent, content-hashed plan cache (planner-as-a-service substrate).

``repro_torch.plancache`` makes the solver's expensive per-layer searches
durable: every ``solver.solve_cached`` / ``solver.best_s2_cached`` result
is written to an on-disk store keyed by a content hash of the frozen
``(ConvSpec, p, HardwareModel, search-knobs)`` tuple, canonicalized so
default-equivalent calls collide.  A later process — a re-run sweep, a
degraded-mode re-plan, the ``repro_torch.launch.plan_server`` CLI —
answers the same query from disk in milliseconds and bit-identically.

The package splits into:

``store``
    The on-disk store itself: one JSON file per entry, atomic writes
    (tmp file + ``os.replace``), a versioned schema, and typed corruption
    recovery — a bad entry raises :class:`CacheCorruptionError`
    internally, is evicted, and the query transparently re-solves; the
    store never trusts or crashes on a damaged file.  Activation is via
    the ``REPRO_PLAN_CACHE`` env var (a directory) or
    :func:`store.configure`.

``codec``
    Canonical-key construction (exact digest + the *family* digest that
    groups entries differing only in budget/``p`` — the nearest-scenario
    warm-start neighbourhood) and loss-free JSON serialization of
    ``SolveResult`` / ``S2Result`` strategies, plus
    :func:`codec.plan_fingerprint` for bit-identical plan comparisons.

``repro_torch.core`` imports this package lazily (inside function bodies)
and only when the store is configured, so the default in-memory-LRU-only
behaviour is untouched.
"""
from repro_torch.plancache.store import (  # noqa: F401
    ENV_VAR, SCHEMA_VERSION, CacheCorruptionError, CacheSchemaError,
    PlanCacheError, PlanStore, active_store, configure, reset)
