"""Repo-specific AST lint for ``src/repro_torch`` —
``python -m repro_torch.analysis.lint``.

Six rules tuned to this codebase's failure modes (generic style is
ruff's job; these are semantic):

``L001 frozen-mutation``
    Assignment to ``self.<attr>`` inside a method of a
    ``@dataclass(frozen=True)`` class (outside ``__post_init__``): raises
    ``FrozenInstanceError`` at runtime — always a latent bug.
``L002 float-eq``
    ``==`` / ``!=`` on duration/cost/objective-named operands: Def-3
    durations are floats built by summation; exact comparison is only
    safe against the literal ``0`` emptiness guard (which is allowed).
``L003 unseeded-random``
    Module-level ``random.*`` / ``np.random.*`` calls in library code:
    planners must be deterministic for a fixed ``rng_seed``; use
    ``random.Random(seed)`` / ``np.random.default_rng(seed)``.
``L004 lru-mutable-arg``
    An ``lru_cache``d function whose signature admits mutable
    (unhashable) arguments — ``TypeError`` at the first real call, or
    worse, a default that silently aliases across calls.
``L005 dead-public-api``
    A public function/method defined under ``core/`` that no code in
    the package or its drivers (``chip_smoke.py``, ``tools/``, the
    port's examples ``examples/torch_*.py``) references (tests do not
    count — "priced and tested but unused" is exactly the finding).
    Suppress deliberate API with a ``# lint: public-api`` pragma, or
    mark a not-yet-wired entry point ``# lint: experimental-api``.
``L006 bare-assert``
    ``assert`` in ``core/``, ``sim/`` or ``kernels/``: planner,
    simulator and kernel-wrapper invariants vanish under ``python -O``
    — raise an explicit exception (``KernelShapeError`` for kernel
    geometry) instead.  (``models/`` keeps device-side shape asserts:
    they guard tracer shapes, not plan legality.)

Exit code 0 when clean, 1 when any finding fires — CI-ready.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import pathlib
import sys
from typing import Iterable

_FLOAT_NAME_PARTS = ("duration", "objective", "cost", "saved", "saving")
_SEEDED_NP_RANDOM = ("default_rng", "SeedSequence", "Generator", "Philox",
                     "PCG64")
_MUTABLE_TYPE_NAMES = {"list", "dict", "set", "List", "Dict", "Set",
                       "MutableSequence", "MutableMapping", "MutableSet",
                       "bytearray"}
_PRAGMAS = ("lint: public-api", "lint: experimental-api")
#: where the default run (no paths given) looks for L005 usages besides
#: the package: the port's drivers and examples, as glob patterns
#: relative to the repo root (the reference's are its benchmarks/ and
#: examples/, which drive the JAX package)
USAGE_ROOTS = ("chip_smoke.py", "tools", "examples/torch_*.py")


def usage_paths(repo_root: pathlib.Path) -> list[pathlib.Path]:
    """The files and directories :data:`USAGE_ROOTS` names under
    ``repo_root``, those that exist."""
    return sorted(p for pattern in USAGE_ROOTS
                  for p in repo_root.glob(pattern))


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _rel(path: pathlib.Path, base: pathlib.Path) -> str:
    try:
        return str(path.relative_to(base))
    except ValueError:
        return str(path)


def _name_of(node: ast.AST) -> str | None:
    """Best-effort identifier of an expression (for name-pattern rules)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Call):
        return _name_of(node.func)
    return None


def _is_zero_constant(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and not isinstance(
        node.value, bool) and node.value == 0


def _is_frozen_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        if isinstance(dec, ast.Call) and \
                _name_of(dec.func) == "dataclass":
            for kw in dec.keywords:
                if kw.arg == "frozen" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is True:
                    return True
    return False


def _has_pragma(lines: list[str], lineno: int) -> bool:
    """Pragma on the flagged line or the line above it."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and any(p in lines[ln - 1]
                                         for p in _PRAGMAS):
            return True
    return False


# --------------------------------------------------------------------- #
# Per-file rules (L001-L004, L006)
# --------------------------------------------------------------------- #

def _check_frozen_mutation(tree: ast.Module, rel: str,
                           out: list[Finding]) -> None:
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef) or not _is_frozen_dataclass(cls):
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in ("__post_init__", "__new__"):
                continue   # object.__setattr__ territory
            for node in ast.walk(fn):
                targets: list[ast.expr] = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target] if node.target is not None else []
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        out.append(Finding(
                            "L001 frozen-mutation", rel, node.lineno,
                            f"assignment to self.{t.attr} in frozen "
                            f"dataclass {cls.name}.{fn.name}"))


def _check_float_eq(tree: ast.Module, rel: str, out: list[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        operands = [node.left] + list(node.comparators)
        for i, op in enumerate(node.ops):
            if not isinstance(op, (ast.Eq, ast.NotEq)):
                continue
            pair = (operands[i], operands[i + 1])
            names = [(_name_of(x) or "").lower() for x in pair]
            if not any(any(p in n for p in _FLOAT_NAME_PARTS)
                       for n in names):
                continue
            if any(_is_zero_constant(x) for x in pair):
                continue   # emptiness guard: 0.0 is exactly representable
            shown = next(n for n in names
                         if any(p in n for p in _FLOAT_NAME_PARTS))
            out.append(Finding(
                "L002 float-eq", rel, node.lineno,
                f"exact float comparison on {shown!r} — use a tolerance "
                f"(math.isclose) or compare to literal 0"))


def _check_unseeded_random(tree: ast.Module, rel: str,
                           out: list[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute):
            continue
        func = node.func
        # random.<fn>(...)
        if isinstance(func.value, ast.Name) and func.value.id == "random":
            if func.attr == "Random" and node.args:
                continue   # random.Random(seed): deterministic
            out.append(Finding(
                "L003 unseeded-random", rel, node.lineno,
                f"random.{func.attr}(...) uses the unseeded global RNG — "
                f"pass a random.Random(seed) instance"))
        # np.random.<fn>(...) / numpy.random.<fn>(...)
        elif isinstance(func.value, ast.Attribute) and \
                func.value.attr == "random" and \
                isinstance(func.value.value, ast.Name) and \
                func.value.value.id in ("np", "numpy"):
            if func.attr in _SEEDED_NP_RANDOM and node.args:
                continue   # np.random.default_rng(seed) etc.
            out.append(Finding(
                "L003 unseeded-random", rel, node.lineno,
                f"np.random.{func.attr}(...) is unseeded (or legacy "
                f"global-state) — use np.random.default_rng(seed)"))


def _lru_decorated(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    for dec in fn.decorator_list:
        if _name_of(dec) in ("lru_cache", "cache"):
            return True
    return False


def _annotation_mutable(ann: ast.expr | None) -> str | None:
    if ann is None:
        return None
    base = ann.value if isinstance(ann, ast.Subscript) else ann
    name = _name_of(base)
    if name in _MUTABLE_TYPE_NAMES:
        return name
    return None


def _check_lru_mutable(tree: ast.Module, rel: str,
                       out: list[Finding]) -> None:
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _lru_decorated(fn):
            continue
        args = fn.args
        all_args = (args.posonlyargs + args.args + args.kwonlyargs)
        for a in all_args:
            bad = _annotation_mutable(a.annotation)
            if bad is not None:
                out.append(Finding(
                    "L004 lru-mutable-arg", rel, a.lineno,
                    f"lru_cached {fn.name}() takes {a.arg}: {bad} — "
                    f"unhashable at call time; use a tuple/frozen type"))
        for default in list(args.defaults) + [
                d for d in args.kw_defaults if d is not None]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(default, ast.Call)
                    and _name_of(default.func) in ("list", "dict", "set")):
                out.append(Finding(
                    "L004 lru-mutable-arg", rel, default.lineno,
                    f"lru_cached {fn.name}() has a mutable default"))


def _check_bare_assert(tree: ast.Module, rel: str, lines: list[str],
                       out: list[Finding]) -> None:
    parts = pathlib.PurePath(rel).parts
    if not ("core" in parts or "sim" in parts or "kernels" in parts
            or "runtime" in parts or "resil" in parts):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Assert) and not _has_pragma(
                lines, node.lineno):
            out.append(Finding(
                "L006 bare-assert", rel, node.lineno,
                "assert vanishes under python -O — raise an explicit "
                "exception for planner/simulator invariants"))


# --------------------------------------------------------------------- #
# Cross-file rule: L005 dead-public-api
# --------------------------------------------------------------------- #

def _public_core_defs(tree: ast.Module, rel: str, lines: list[str],
                      ) -> list[tuple[str, str, int]]:
    """(name, qualified label, line) of public defs in a core/ module."""
    if "core" not in pathlib.PurePath(rel).parts:
        return []
    defs = []

    def visit(body: Iterable[ast.stmt], prefix: str) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name.startswith("_"):
                    continue
                if _has_pragma(lines, node.lineno):
                    continue
                defs.append((node.name, f"{prefix}{node.name}",
                             node.lineno))
            elif isinstance(node, ast.ClassDef):
                visit(node.body, f"{node.name}.")

    visit(tree.body, "")
    return defs


def _collect_uses(tree: ast.Module) -> set[str]:
    uses: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            uses.add(node.id)
        elif isinstance(node, ast.Attribute):
            uses.add(node.attr)
        elif isinstance(node, (ast.ImportFrom, ast.Import)):
            for alias in node.names:
                uses.add(alias.name.split(".")[-1])
    return uses


# --------------------------------------------------------------------- #
# Driver
# --------------------------------------------------------------------- #

def iter_python_files(root: pathlib.Path) -> list[pathlib.Path]:
    if root.is_file():
        return [root]
    return sorted(root.rglob("*.py"))


def run_lint(paths: "list[pathlib.Path]",
             usage_paths: "list[pathlib.Path] | None" = None,
             base: "pathlib.Path | None" = None) -> list[Finding]:
    """Lint ``paths``; resolve L005 usages against ``usage_paths`` (which
    default to ``paths``).  Returns findings sorted by file/line."""
    base = base or pathlib.Path.cwd()
    findings: list[Finding] = []
    defs: list[tuple[str, str, int, str]] = []   # name, label, line, rel
    uses: set[str] = set()
    use_counts: dict[str, int] = {}

    lint_files = {f for p in paths for f in iter_python_files(p)}
    usage_files = set(lint_files)
    for p in (usage_paths or []):
        usage_files.update(iter_python_files(p))

    trees: dict[pathlib.Path, tuple[ast.Module, list[str]]] = {}
    for f in sorted(usage_files):
        try:
            src = f.read_text()
            trees[f] = (ast.parse(src, filename=str(f)), src.splitlines())
        except (SyntaxError, OSError) as e:
            findings.append(Finding("L000 parse-error", _rel(f, base),
                                    getattr(e, "lineno", 0) or 0, str(e)))

    for f, (tree, lines) in trees.items():
        rel = _rel(f, base)
        for name in _collect_uses(tree):
            use_counts[name] = use_counts.get(name, 0) + 1
        uses.update(_collect_uses(tree))
        if f not in lint_files:
            continue
        _check_frozen_mutation(tree, rel, findings)
        _check_float_eq(tree, rel, findings)
        _check_unseeded_random(tree, rel, findings)
        _check_lru_mutable(tree, rel, findings)
        _check_bare_assert(tree, rel, lines, findings)
        for name, label, line in _public_core_defs(tree, rel, lines):
            defs.append((name, label, line, rel))

    for name, label, line, rel in defs:
        if name not in uses:
            findings.append(Finding(
                "L005 dead-public-api", rel, line,
                f"public {label}() is never referenced from src/, "
                f"chip_smoke.py, tools/ or examples/torch_*.py — wire "
                f"it, delete it, or mark it '# lint: experimental-api'"))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def main(argv: "list[str] | None" = None) -> int:
    repo_root = pathlib.Path(__file__).resolve().parents[3]
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific AST lint (see module docstring)")
    ap.add_argument("paths", nargs="*", type=pathlib.Path,
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON")
    ns = ap.parse_args(argv)

    if ns.paths:
        paths = [p.resolve() for p in ns.paths]
        usage = []
    else:
        paths = [repo_root / "src" / "repro_torch"]
        usage = usage_paths(repo_root)
    findings = run_lint(paths, usage_paths=usage, base=repo_root)
    if ns.json:
        print(json.dumps([f.to_json() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"repro_torch.analysis.lint: {len(findings)} finding(s) over "
              f"{len(paths)} root(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
