"""How every wrapper launches and counts a hand-written kernel
(``kernels._build.Launcher``) and the registry it counts in
(``obs.counters``), on the CPU: a fake library and a fake C function in
place of a built one, the card's device and stream calls stubbed."""
from __future__ import annotations

import contextlib
import ctypes
import types

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.launch import steps
from repro_torch.obs import counters

NAME = "fake_kernel"
SEEDED = ("conv2d_offload", "conv2d_offload_planned", "flash_decode",
          "flash_decode_combine", "flash_decode_mma", "block_matmul_osta",
          "block_matmul_rmw", "ssd_update_kernel", "ssm_update",
          "zamba2_block0", "zamba2_block1")


class _FakeFn:
    """A C launch function that records its arguments and returns
    ``code``."""

    def __init__(self, code: int):
        self.code, self.calls = code, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


class _FakeLib:
    """A loaded library with one launch function, ``fake_launch``, that
    counts its lookups, and the error string every library exports."""

    def __init__(self, code: int):
        self.fn, self.lookups = _FakeFn(code), 0

    def __getattr__(self, name):
        if name != "fake_launch":
            raise AttributeError(name)
        self.lookups += 1
        return self.fn

    @staticmethod
    def repro_cuda_error_string(code: int) -> bytes:
        return b"an illegal memory access was encountered"


@pytest.fixture
def card(monkeypatch):
    """Device 0 current, stream 7, and the devices entered, in order."""
    entered = []

    @contextlib.contextmanager
    def device(d):
        entered.append(d)
        yield

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setitem(counters.COUNTS, NAME, 0)
    return entered


def _launcher(monkeypatch, code: int) -> tuple[_build.Launcher, _FakeLib]:
    lib = _FakeLib(code)
    monkeypatch.setitem(_build._libs, "fake", lib)
    return _build.Launcher("fake", "fake_launch",
                           [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
                           NAME), lib


def test_the_launcher_binds_once_over_many_calls(monkeypatch, card):
    launch, lib = _launcher(monkeypatch, 0)
    assert launch.c is None and lib.lookups == 0       # nothing at creation
    for i in range(5):
        launch(torch.device("cuda", 0), 16 * i, i)
    assert lib.lookups == 1 and launch.c is lib.fn
    assert lib.fn.argtypes == launch.argtypes
    assert lib.fn.restype is ctypes.c_int
    assert lib.fn.calls == [(16 * i, i, 7) for i in range(5)]
    assert card == []                    # the current device: not entered


def test_the_launcher_enters_a_device_that_is_not_current(monkeypatch,
                                                          card):
    launch, lib = _launcher(monkeypatch, 0)
    launch(torch.device("cuda", 1), 0, 0)
    assert card == [torch.device("cuda", 1)] and len(lib.fn.calls) == 1


def test_a_refused_launch_raises_with_the_librarys_string_and_counts_nothing(
        monkeypatch, card):
    launch, _ = _launcher(monkeypatch, 700)
    with pytest.raises(RuntimeError, match=f"{NAME} launch: CUDA error 700 "
                       r"\(an illegal memory access was encountered\)"):
        launch(torch.device("cuda", 0), 0, 0)
    assert counters.COUNTS[NAME] == 0


def test_a_launch_counts_once_under_its_name(monkeypatch, card):
    launch, _ = _launcher(monkeypatch, 0)
    before = dict(counters.COUNTS)
    launch(torch.device("cuda", 0), 0, 0)
    assert counters.COUNTS == dict(before, **{NAME: before[NAME] + 1})


def test_a_launcher_using_a_function_of_its_own_never_binds(monkeypatch,
                                                            card):
    launch, lib = _launcher(monkeypatch, 0)
    own = _FakeFn(0)
    mine = launch.using(own)
    mine(torch.device("cuda", 0), 1, 2)
    assert own.calls == [(1, 2, 7)] and lib.lookups == 0
    assert launch.c is None and mine.name == NAME
    assert counters.COUNTS[NAME] == 1


@pytest.mark.parametrize("name", SEEDED)
def test_step_counters_hold_each_seeded_name(name):
    assert name in counters.COUNTS
    got = steps.step_counters()
    assert got[name] == counters.COUNTS[name]
    assert got is not counters.COUNTS


def test_count_starts_a_new_name_at_zero(monkeypatch):
    monkeypatch.setitem(counters.COUNTS, NAME, 0)
    del counters.COUNTS[NAME]
    counters.count(NAME)
    counters.count(NAME)
    assert counters.COUNTS[NAME] == 2
