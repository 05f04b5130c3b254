"""The port stands alone: nothing under ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or ``repro``; every module imports on a
machine without ``nvcc`` and ``triton``; and nothing lands on the CPU
unasked."""
import ast
import importlib
import pathlib
import subprocess
import sys

import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_the_port_has_the_modules_of_this_slice():
    mods = set(_modules())
    for want in ("core.conv_spec", "core.cost_model", "core.formalism",
                 "core.strategies", "core.strategies_s2", "core.ilp",
                 "core.solver", "core.network_planner", "core.multichip",
                 "core.planner", "obs.metrics", "analysis.diagnostics",
                 "analysis.access", "analysis.verifier", "configs.lenet5",
                 "configs.resnet8", "configs.tight", "configs.networks",
                 "kernels.ref", "kernels._build", "kernels.conv2d_offload",
                 "kernels.ops", "kernels.emit", "reference_io"):
        assert f"repro_torch.{want}" in mods
    assert (PKG / "kernels" / "csrc" / "conv2d_offload.cu").exists()
    assert (PKG / "kernels" / "csrc" / "conv2d_offload_planned.cu").exists()


@pytest.mark.parametrize("module", _modules())
def test_module_imports_without_nvcc_and_triton(module):
    importlib.import_module(module)


def test_importing_the_port_pulls_in_no_jax():
    """In a fresh interpreter (this one has JAX loaded for the parity
    tests), importing every module of the port loads neither ``jax`` nor
    ``repro``, and builds nothing."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton')]\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build.build_dir().exists() or "
        "not list(_build.build_dir().glob('*.so'))\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})


def test_layer_from_numpy_does_not_land_on_the_cpu_unasked():
    """The default device is the card; where there is none the call
    raises instead of giving CPU tensors."""
    import numpy as np
    from repro_torch.reference_io import layer_from_numpy, resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    x, w = np.zeros((1, 4, 4)), np.zeros((1, 1, 3, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        layer_from_numpy(x, w)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert layer_from_numpy(x, w, device="cpu")[0].device.type == "cpu"


def test_a_cuda_tensor_never_falls_back_to_the_plain_version(monkeypatch):
    """For a tensor that is not on the CPU the wrappers go to the kernel's
    build and launch, or raise: a ``meta`` tensor (no card needed) is
    refused, and the plain versions are never reached."""
    from repro_torch.kernels import KernelShapeError
    from repro_torch.kernels import conv2d_offload as conv
    for plain in ("conv2d_offload_plain", "conv2d_offload_planned_plain"):
        monkeypatch.setattr(
            conv, plain,
            lambda *a, **k: pytest.fail("fell back to the plain version"))
    x = torch.zeros((2, 8, 8), device="meta")
    w = torch.zeros((3, 2, 3, 3), device="meta")
    for fn in (conv.conv2d_offload, conv.conv2d_offload_planned):
        with pytest.raises(KernelShapeError, match="unsupported device"):
            fn(x, w, t_run=3)


def test_without_nvcc_a_build_raises_with_a_clear_message(monkeypatch,
                                                          tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("conv2d_offload")
    assert not list(tmp_path.glob("*.so"))


def test_plan_cache_variable_is_refused_not_ignored(monkeypatch):
    from repro_torch.core import solver
    monkeypatch.setenv("REPRO_PLAN_CACHE", "/nonexistent")
    with pytest.raises(NotImplementedError, match="plancache"):
        solver._plan_store()
    monkeypatch.delenv("REPRO_PLAN_CACHE")
    assert solver._plan_store() == (None, None)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout
