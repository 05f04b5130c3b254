"""The port's repo lint (``repro_torch.analysis.lint``) against the JAX
package's.

The six rules are the reference's, unchanged: on the fixture sources of
``tests/test_lint.py`` both lints give the same findings, rule, path,
line and message; only the message of ``L005 dead-public-api`` names
where the port looks for usages (its drivers, ``chip_smoke.py`` and
``tools/``, and its examples ``examples/torch_*.py``, in place of the
JAX package's ``benchmarks/`` and ``examples/``).  The CI gate:
``src/repro_torch`` lints clean.
"""
import pathlib

import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis import lint
from test_lint import BAD_SOURCE

ROOT = pathlib.Path(__file__).resolve().parent.parent

FIXTURES = {
    "core/bad.py": BAD_SOURCE,
    "kernels/dev.py": "def f(x):\n    assert x.ndim == 2\n    return x\n",
    "runtime/dev.py": "def f(x):\n    assert x >= 0\n    return x\n",
    "resil/dev.py": "def f(x):\n    assert x >= 0\n    return x\n",
    "models/net.py": "def f(x):\n    assert x.ndim == 2\n    return x\n",
    "oops.py": "def broken(:\n",
}


def _write(tmp_path, rel, source):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return path


def _reference_message(finding):
    """The port's finding in the reference's words: only L005 names its
    usage roots."""
    return finding.message.replace(
        "chip_smoke.py, tools/ or examples/torch_*.py",
        "benchmarks/ or examples/")


@pytest.mark.parametrize("rel", sorted(FIXTURES))
def test_findings_equal_the_reference_on_the_fixture_sources(tmp_path,
                                                             rel):
    path = _write(tmp_path, rel, FIXTURES[rel])
    mine = lint.run_lint([path], base=tmp_path)
    theirs = jlint.run_lint([path], base=tmp_path)
    assert [(f.rule, f.path, f.line) for f in mine] == \
        [(f.rule, f.path, f.line) for f in theirs]
    assert [_reference_message(f) for f in mine] == \
        [f.message for f in theirs]


def test_every_rule_fires_on_the_bad_file(tmp_path):
    path = _write(tmp_path, "core/bad.py", BAD_SOURCE)
    by_rule = {}
    for f in lint.run_lint([path], base=tmp_path):
        by_rule.setdefault(f.rule.split(" ")[0], []).append(f)
    assert set(by_rule) == {"L001", "L002", "L003", "L004", "L005", "L006"}
    assert len(by_rule["L002"]) == 1           # the ==0 guard is allowed
    assert len(by_rule["L003"]) == 2           # seeded calls are allowed
    assert all("dead_api" in f.message for f in by_rule["L005"])
    assert not any("pinned_api" in f.message for f in by_rule["L005"])
    assert "chip_smoke.py, tools/ or examples/torch_*.py" in \
        by_rule["L005"][0].message


def test_usages_in_the_drivers_clear_dead_api(tmp_path):
    """A public core function that only a driver calls is not dead: the
    port's usage roots vouch for it, as the JAX package's benchmarks do
    for its own."""
    core = _write(tmp_path, "core/api.py", "def only_the_driver():\n"
                  "    return 1\n")
    driver = _write(tmp_path, "tools/probe.py",
                    "from core.api import only_the_driver\n")
    assert [f.rule for f in lint.run_lint([core], base=tmp_path)] == \
        ["L005 dead-public-api"]
    assert lint.run_lint([core], usage_paths=[driver], base=tmp_path) == []


def test_a_port_example_clears_dead_api(tmp_path):
    """As the reference's ``examples/`` do for the JAX package, the port's
    ``examples/torch_*.py`` vouch for a public core function; the
    reference's own examples, which import ``repro``, do not."""
    core = _write(tmp_path, "core/api.py", "def only_the_example():\n"
                  "    return 1\n")
    _write(tmp_path, "examples/demo.py",
           "from repro.core.api import only_the_example\n")
    assert [f.rule for f in lint.run_lint(
        [core], usage_paths=lint.usage_paths(tmp_path), base=tmp_path)] \
        == ["L005 dead-public-api"]
    _write(tmp_path, "examples/torch_demo.py",
           "from repro_torch.core.api import only_the_example\n")
    assert lint.run_lint([core], usage_paths=lint.usage_paths(tmp_path),
                         base=tmp_path) == []


def test_default_run_lints_the_port_with_its_drivers_as_usage_roots():
    assert lint.USAGE_ROOTS == ("chip_smoke.py", "tools",
                                "examples/torch_*.py")
    found = lint.usage_paths(ROOT)
    assert ROOT / "chip_smoke.py" in found and ROOT / "tools" in found
    assert sorted(p.name for p in found if p.parent.name == "examples") \
        == sorted(f"torch_{n}.py" for n in (
            "quickstart", "plan_network", "plan_multichip",
            "optimize_offload", "s2_memory_scaling", "serve_decode",
            "train_lm"))


def test_the_port_lints_clean(capsys):
    """The CI gate: ``python -m repro_torch.analysis.lint`` exits 0 over
    ``src/repro_torch``."""
    assert lint.main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    findings = lint.run_lint(
        [ROOT / "src" / "repro_torch"],
        usage_paths=lint.usage_paths(ROOT), base=ROOT)
    assert findings == []
