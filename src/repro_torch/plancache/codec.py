"""Canonical keys and loss-free JSON codecs for the persistent plan store.

Keys are **canonicalized**: every search knob is materialized with its
default applied, so ``solve_cached(spec, p, hw)`` and
``solve_cached(spec, p, hw, nb_data_reload=2, use_milp=True, ...)`` hash
to the same entry (``functools.lru_cache`` treats them as distinct; the
persistent layer must not).  Each key comes with a *family* digest — the
key minus the scenario axes sweeps vary (``p`` and ``hw.size_mem``) —
which names the warm-start neighbourhood: entries for the same layer and
knobs at neighbouring budgets/group sizes.

Serialization is exact: strategies reduce to their defining integer
tuples (``GroupedStrategy`` groups; ``S2Strategy`` kernel groups +
schedule) plus the 8-int ``ConvSpec``, and reconstruction re-runs the
frozen dataclasses' own ``__post_init__`` validation — a corrupted
payload fails loudly into
:class:`~repro_torch.plancache.store.CacheCorruptionError`
instead of producing an illegal strategy.  Floats round-trip bit-exactly
through JSON (shortest-repr), so a decoded ``SolveResult`` compares equal
to the solved one.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core import solver as solver_mod
from repro_torch.core import strategies_s2 as s2_mod
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.strategies import GroupedStrategy
from repro_torch.plancache.store import CacheCorruptionError, canonical_digest

#: ``solver.solve_cached`` knob defaults, applied before hashing so
#: default-equivalent calls collide.  Must match the solver signature.
SOLVE_KNOB_DEFAULTS: dict[str, Any] = {
    "nb_data_reload": 2,
    "time_limit": 30.0,
    "polish_iters": 30_000,
    "use_milp": True,
    "rng_seed": 0,
    "polish_restarts": 1,
}


# --------------------------------------------------------------------- #
# Canonical keys
# --------------------------------------------------------------------- #

def spec_key(spec: ConvSpec) -> list[int]:
    return [spec.c_in, spec.h_in, spec.w_in, spec.n_kernels,
            spec.h_k, spec.w_k, spec.s_h, spec.s_w]


def hw_key(hw: HardwareModel) -> dict[str, Any]:
    return {"nbop_pe": hw.nbop_pe, "size_mem": hw.size_mem,
            "t_l": hw.t_l, "t_w": hw.t_w, "t_acc": hw.t_acc}


def solve_key(spec: ConvSpec, p: int, hw: HardwareModel,
              **knobs: Any) -> tuple[dict, str]:
    """(canonical key, family digest) for a ``solve_cached`` query.  The
    family drops ``p`` and ``hw.size_mem`` — the axes budget/chip sweeps
    vary — so same-family entries are warm-start neighbours."""
    full = dict(SOLVE_KNOB_DEFAULTS)
    for name, value in knobs.items():
        if name not in SOLVE_KNOB_DEFAULTS:
            raise TypeError(f"unknown solve knob {name!r}")
        full[name] = value
    hwk = hw_key(hw)
    key = {"spec": spec_key(spec), "p": int(p), "hw": hwk, "knobs": full}
    family_hw = {k: v for k, v in hwk.items() if k != "size_mem"}
    family = {"spec": key["spec"], "hw": family_hw, "knobs": full}
    return key, canonical_digest(family)


def s2_key(spec: ConvSpec, hw: HardwareModel) -> tuple[dict, str]:
    """(canonical key, family digest) for a ``best_s2_cached`` query."""
    hwk = hw_key(hw)
    key = {"spec": spec_key(spec), "hw": hwk}
    family_hw = {k: v for k, v in hwk.items() if k != "size_mem"}
    family = {"spec": key["spec"], "hw": family_hw}
    return key, canonical_digest(family)


# --------------------------------------------------------------------- #
# Strategy / result codecs
# --------------------------------------------------------------------- #

def strategy_to_json(s: "GroupedStrategy | s2_mod.S2Strategy") -> dict:
    if isinstance(s, GroupedStrategy):
        return {"kind": "s1", "name": s.name, "spec": spec_key(s.spec),
                "groups": [list(g) for g in s.groups]}
    if isinstance(s, s2_mod.S2Strategy):
        return {"kind": "s2", "name": s.name, "spec": spec_key(s.spec),
                "kernel_groups": [list(g) for g in s.kernel_groups],
                "schedule": [[list(g), kg] for g, kg in s.schedule]}
    raise TypeError(f"unserializable strategy type {type(s).__name__}")


def strategy_from_json(d: dict) -> "GroupedStrategy | s2_mod.S2Strategy":
    try:
        kind = d["kind"]
        spec = ConvSpec(*(int(v) for v in d["spec"]))
        if kind == "s1":
            return GroupedStrategy(
                str(d["name"]), spec,
                tuple(tuple(int(i) for i in g) for g in d["groups"]))
        if kind == "s2":
            return s2_mod.S2Strategy(
                str(d["name"]), spec,
                tuple(tuple(int(i) for i in g)
                      for g in d["kernel_groups"]),
                tuple((tuple(int(i) for i in g), int(kg))
                      for g, kg in d["schedule"]))
    except CacheCorruptionError:
        raise
    except (KeyError, TypeError, ValueError, IndexError) as e:
        raise CacheCorruptionError(f"bad strategy payload: {e}") from e
    raise CacheCorruptionError(f"unknown strategy kind {kind!r}")


def _opt_float(v: Any) -> float | None:
    return None if v is None else float(v)


def solve_result_to_json(res: "solver_mod.SolveResult") -> dict:
    return {
        "strategy": strategy_to_json(res.strategy),
        "objective": res.objective,
        "lower_bound": res.lower_bound,
        "seed_objective": res.seed_objective,
        "milp_status": res.milp_status,
        "milp_objective": res.milp_objective,
        "polish_objective": res.polish_objective,
        "reload_ok": res.reload_ok,
        "mode": res.mode,
    }


def solve_result_from_json(d: dict) -> "solver_mod.SolveResult":
    try:
        return solver_mod.SolveResult(
            strategy=strategy_from_json(d["strategy"]),
            objective=float(d["objective"]),
            lower_bound=float(d["lower_bound"]),
            seed_objective=float(d["seed_objective"]),
            milp_status=str(d["milp_status"]),
            milp_objective=_opt_float(d["milp_objective"]),
            polish_objective=float(d["polish_objective"]),
            reload_ok=bool(d["reload_ok"]),
            mode=str(d["mode"]))
    except CacheCorruptionError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise CacheCorruptionError(f"bad SolveResult payload: {e}") from e


def s2_result_to_json(res: "s2_mod.S2Result") -> dict:
    return {
        "strategy": strategy_to_json(res.strategy),
        "objective": res.objective,
        "peak_memory": res.peak_memory,
        "feasible_s1": res.feasible_s1,
        "seed_strategy": (None if res.seed_strategy is None
                          else strategy_to_json(res.seed_strategy)),
        "seed_objective": res.seed_objective,
        "milp_status": res.milp_status,
        "milp_objective": res.milp_objective,
    }


def s2_result_from_json(d: dict) -> "s2_mod.S2Result":
    try:
        strategy = strategy_from_json(d["strategy"])
        if not isinstance(strategy, s2_mod.S2Strategy):
            raise CacheCorruptionError("S2Result holds a non-S2 strategy")
        seed = d["seed_strategy"]
        seed_strategy = None if seed is None else strategy_from_json(seed)
        if seed_strategy is not None and \
                not isinstance(seed_strategy, s2_mod.S2Strategy):
            raise CacheCorruptionError("S2Result seed is a non-S2 strategy")
        return s2_mod.S2Result(
            strategy=strategy,
            objective=float(d["objective"]),
            peak_memory=int(d["peak_memory"]),
            feasible_s1=bool(d["feasible_s1"]),
            seed_strategy=seed_strategy,
            seed_objective=_opt_float(d["seed_objective"]),
            milp_status=str(d["milp_status"]),
            milp_objective=_opt_float(d["milp_objective"]))
    except CacheCorruptionError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise CacheCorruptionError(f"bad S2Result payload: {e}") from e


# --------------------------------------------------------------------- #
# Plan fingerprints (bit-identical cold/warm comparison)
# --------------------------------------------------------------------- #

def plan_fingerprint(plan: Any) -> str:
    """Stable content hash of a plan's *decisions* — per-layer strategies,
    sharding modes, reuse choices and durations — independent of
    planning wall-clock and cache counters.  Works for ``NetworkPlan``
    and ``MultiChipPlan``; two plans with equal fingerprints schedule the
    same work identically."""
    rows: list[dict] = []
    for lp in plan.layers:
        if hasattr(lp, "shards"):              # MultiChipLayerPlan
            rows.append({
                "mode": lp.mode,
                "ici_elements": lp.ici_elements,
                "compute_duration": lp.compute_duration,
                "overlap": lp.overlap,
                "shards": [
                    {"chip": sh.chip, "p": sh.p,
                     "spec": spec_key(sh.spec),
                     "out_rows": (None if sh.out_rows is None
                                  else list(sh.out_rows)),
                     "kernel_range": (None if sh.kernel_range is None
                                      else list(sh.kernel_range)),
                     "gross_duration": sh.gross_duration,
                     "strategy": strategy_to_json(sh.result.strategy)}
                    for sh in lp.shards],
            })
        else:                                   # LayerPlan
            rows.append({
                "p": lp.p,
                "spec": spec_key(lp.spec),
                "strategy": strategy_to_json(lp.result.strategy),
                "reuse_input": lp.reuse_input,
                "reuse_output": lp.reuse_output,
                "window_rows": lp.window_rows,
                "duration": lp.duration,
            })
    return canonical_digest(
        {"layers": rows, "total_duration": plan.total_duration})
