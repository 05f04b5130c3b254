"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library: ``nvcc`` for ``sm_90a`` into ``build/`` beside this file (or into
``$REPRO_TORCH_BUILD_DIR``), loaded with :mod:`ctypes`.  A source that
includes none of PyTorch's headers builds in seconds, which is why the
kernels are bound this way and not through
``torch.utils.cpp_extension.load``.  Nothing is built when a module is
imported: a machine without ``nvcc`` can import the whole package, and
only a kernel launch on a CUDA tensor reaches :func:`load`.

The library's file name carries a hash of every file under ``csrc/`` and
of the compiler flags, so an edited source is rebuilt and a stale library
is never loaded.  :func:`build_all` starts one ``nvcc`` per source, all
at once.  No library links ``-lcuda``: the block GeMM's wgmma core gets
the driver's ``cuTensorMapEncodeTiled`` through the runtime
(``cudaGetDriverEntryPointByVersion``).

Every wrapper launches its kernel through a :class:`Launcher`, one held
at module level for each launch function: it binds the C function at the
first launch, calls it on the current stream of the tensors' device,
raises on an error code and counts the launch in ``obs.counters.COUNTS``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from repro_torch.obs import counters

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source; carries its output."""


def build_dir() -> pathlib.Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return pathlib.Path(override)
    return pathlib.Path(__file__).resolve().parent / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (looked on PATH, in $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels cannot be built on this machine")


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> pathlib.Path:
    return build_dir() / f"lib{name}-{_sources_hash()}.so"


def _start(name: str, extra_flags: tuple[str, ...] = ()
           ) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no CUDA source {src}")
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    # nvcc writes to a private name; the finished library is moved into
    # place, so a build that was cut off leaves nothing that loads
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-I", str(CSRC),
           "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: pathlib.Path,
            out: pathlib.Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: tuple[str, ...], *, verbose: bool = False
              ) -> dict[str, str]:
    """Build the named sources that are not built yet, one ``nvcc`` each,
    all started together.  Returns each compiler's output by name;
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    extra = ("-Xptxas", "-v") if verbose else ()
    with _lock:
        started = [(n, *_start(n, extra)) for n in names
                   if verbose or not _lib_path(n).exists()]
        return {n: _finish(n, proc, tmp, out)
                for n, proc, tmp, out in started}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if not _lib_path(name).exists():
        build_all((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def bind(name: str, fn: str, argtypes: list, restype=ctypes.c_int):
    """``fn`` of library ``name`` with its C signature set.  Pointers and
    the stream are ``c_void_p``: without ``argtypes`` ctypes would pass
    each as a 32-bit int and cut the address."""
    f = getattr(load(name), fn)
    f.argtypes = argtypes
    f.restype = restype
    return f


class Launcher:
    """The launch function ``fn`` of library ``lib``, whose C signature is
    ``argtypes`` and whose launches count under ``name``.

    ``launcher(device, *args)`` calls ``fn(*args, stream)`` on the current
    stream of ``device``, entering ``device`` only when it is not the
    current one; raises ``RuntimeError`` with the library's own string
    for a non-zero code, and otherwise adds one to ``name`` in
    ``obs.counters.COUNTS``.  The function is bound (:func:`bind`) at the
    first call, so nothing is built at import.  ``c`` puts a function of
    one's own in place of the built one: a measurement's instrumented
    copy, or a test's fake (:meth:`using`)."""

    def __init__(self, lib: str, fn: str, argtypes: list, name: str,
                 c=None):
        self.lib, self.fn, self.argtypes, self.name = lib, fn, argtypes, name
        self.c = c

    def using(self, c) -> "Launcher":
        """This launcher with ``c`` called in place of the built
        function."""
        return Launcher(self.lib, self.fn, self.argtypes, self.name, c)

    def __call__(self, device: torch.device, *args) -> None:
        if self.c is None:
            self.c = bind(self.lib, self.fn, self.argtypes)
        if device.index == torch.cuda.current_device():
            code = self.c(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                code = self.c(*args, torch.cuda.current_stream().cuda_stream)
        if code:
            msg = load(self.lib).repro_cuda_error_string(code).decode()
            raise RuntimeError(
                f"{self.name} launch: CUDA error {code} ({msg})")
        counters.count(self.name)
