"""The fused Mamba-2 recurrent update (``kernels/ssd_update.py``): its
plain version against the recurrence ``models/ssm.py`` made before the
update became a kernel, the wrapper's contract on CPU tensors, the decode
step on the CPU, and the benchmark's two readers of the kernel; then, marked
``gpu``, the kernel against its plain version on the card::

    python -m pytest -q -m gpu tests/test_torch_ssd_update.py
"""
import dataclasses
import pathlib
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import KernelShapeError
from repro_torch.kernels import ssd_update as su
from repro_torch.models import registry, ssm
from repro_torch.obs.counters import COUNTS

BENCH = pathlib.Path(__file__).resolve().parents[1] / "bench"
sys.path.insert(0, str(BENCH))

from harness import spec  # noqa: E402
from harness.trace import DeviceTrace  # noqa: E402


def _inputs(seed, b, heads, p, n, groups, dtype, device="cpu"):
    """xbc (B, H * P + 2 G N) and dt_raw (B, H) of ``dtype`` (dt_raw a view
    with the batch stride of a projection's row), the per-head constants
    as a published Mamba-2 draws them (A from U(1, 16), dt log-uniform in
    [1e-3, 0.1] as the bias's inverse softplus), and a state (B, H, P, N)
    float32; a few dt_raw past softplus's threshold of 20.  Made on
    ``device``."""
    rng = np.random.default_rng(seed)

    def put(a, dt=torch.float32):
        return torch.tensor(a, dtype=dt, device=device)

    width = heads * p + 2 * groups * n
    xbc = put(rng.standard_normal((b, width)), dtype)
    dt_raw = put(rng.standard_normal((b, heads + 7)), dtype)[:, 3:3 + heads]
    dt_raw[0, :2] = 25.0
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), heads))
    dt_bias = put(dt + np.log(-np.expm1(-dt)))
    a_log = put(np.log(rng.uniform(1, 16, heads)))
    d_skip = put(1 + 0.02 * rng.standard_normal(heads))
    h = put(0.05 * rng.standard_normal((b, heads, p, n)))
    return [xbc, dt_raw, dt_bias, a_log, d_skip, h]


def _recurrence_as_it_was(xbc, dt_raw, dt_bias, a_log, d_skip, h, groups):
    """``ssm._ssd_step``'s recurrence as the decode step ran it before the
    update became a kernel, line for line: (y, the new state)."""
    b = xbc.shape[0]
    n, pdim, g = h.shape[3], h.shape[2], groups
    hl = dt_raw.shape[-1]
    hg = hl // g
    xf = xbc[:, :hl * pdim].reshape(b, g, hg, pdim).float()
    bm = xbc[:, hl * pdim:hl * pdim + g * n].reshape(b, g, n).float()
    cm = xbc[:, hl * pdim + g * n:].reshape(b, g, n).float()
    dt = F.softplus(dt_raw.float() + dt_bias.float()[None])
    a = -torch.exp(a_log.float())
    dec = torch.exp(dt * a[None])
    hstate = h * dec[..., None, None] + torch.einsum(
        "bgh,bghp,bgn->bghpn", dt.view(b, g, hg), xf, bm
    ).reshape(b, hl, pdim, n)
    y = torch.einsum("bgn,bghpn->bghp", cm,
                     hstate.view(b, g, hg, pdim, n)).reshape(b, hl, pdim)
    y = y + xf.reshape(b, hl, pdim) * d_skip.float()[None, :, None]
    return y.reshape(b, hl * pdim).to(xbc.dtype), hstate


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("groups", [1, 2])
def test_the_plain_update_is_the_steps_recurrence_bit_for_bit(groups, n,
                                                              dtype):
    args = _inputs(3, 3, 8, 16, n, groups, dtype)
    h0 = args[-1].clone()
    y, hstate = su.ssd_update_plain(*args, groups=groups)
    want_y, want_h = _recurrence_as_it_was(*args, groups)
    assert torch.equal(y, want_y) and y.dtype == dtype
    assert torch.equal(hstate, want_h)
    assert torch.equal(args[-1], h0)         # the plain version writes no h


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_the_wrapper_on_cpu_tensors_writes_the_plain_state_into_h(groups):
    args = _inputs(4, 2, 8, 16, 32, groups, torch.bfloat16)
    h = args[-1]
    ptr = h.data_ptr()
    want_y, want_h = su.ssd_update_plain(*args, groups=groups)
    before = dict(COUNTS)
    y = su.ssd_update(*args, groups=groups)
    assert torch.equal(y, want_y)
    assert h.data_ptr() == ptr and torch.equal(h, want_h)
    assert COUNTS == before             # the plain path never counts


def _refusals():
    def state_width(a):
        a[5] = a[5].new_zeros(a[5].shape[:3] + (8,))

    def wide_state(a):
        a[5] = a[5].new_zeros(a[5].shape[:3] + (256,))

    def strided_state(a):
        a[5] = a[5].transpose(2, 3).contiguous().transpose(2, 3)

    def bf16_state(a):
        a[5] = a[5].to(torch.bfloat16)

    def xbc_width(a):
        a[0] = a[0][:, :-1]

    def dt_dtype(a):
        a[1] = a[1].float()

    def f16_inputs(a):
        a[0], a[1] = a[0].half(), a[1].half()

    def constants(a):
        a[3] = a[3].to(torch.bfloat16)

    return {"state_width_8": (state_width, "state width"),
            "state_width_256": (wide_state, "state width"),
            "non_contiguous_state": (strided_state, "contiguous"),
            "bf16_state": (bf16_state, "float32"),
            "xbc_width": (xbc_width, "want xbc"),
            "dt_dtype": (dt_dtype, "alike"),
            "f16_inputs": (f16_inputs, "alike"),
            "constants": (constants, "a_log")}


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The check the wrapper makes of CUDA tensors before it launches,
    here on CPU tensors (which the wrapper itself sends to the plain
    version without it)."""
    edit, match = _refusals()[case]
    args = _inputs(5, 2, 8, 16, 16, 2, torch.bfloat16)
    edit(args)
    before = dict(COUNTS)
    with pytest.raises(KernelShapeError, match=match):
        su._geometry(*args, 2)
    assert COUNTS == before


def test_the_wrapper_refuses_groups_that_do_not_divide_the_heads():
    args = _inputs(6, 2, 6, 16, 16, 2, torch.bfloat16)
    args[0] = torch.zeros(2, 6 * 16 + 2 * 4 * 16, dtype=torch.bfloat16)
    with pytest.raises(KernelShapeError, match="divide"):
        su._geometry(*args, 4)


def test_the_kernels_check_refuses_cpu_tensors_it_would_take_on_the_card():
    args = _inputs(6, 2, 8, 16, 16, 2, torch.bfloat16)
    with pytest.raises(KernelShapeError, match="runs on CUDA"):
        su._geometry(*args, 2)


# The refusals the plain version computes all the same (the state widths
# with inputs of that width): on CPU tensors the wrapper takes them, as the
# decode step took them before the kernel.
CPU_ONLY = {"state_width_8": 8, "state_width_256": 256,
            "non_contiguous_state": 16, "bf16_state": 16, "dt_dtype": 16,
            "f16_inputs": 16, "constants": 16}


@pytest.mark.parametrize("case", sorted(CPU_ONLY))
def test_the_wrapper_on_cpu_tensors_takes_what_the_kernel_does_not(case):
    args = _inputs(7, 2, 8, 16, CPU_ONLY[case], 2, torch.bfloat16)
    if not case.startswith("state_width"):
        _refusals()[case][0](args)
        args[5].normal_(0, 0.05, generator=torch.Generator().manual_seed(1))
    h = args[5]
    want_y, want_h = _recurrence_as_it_was(*args, 2)
    before = dict(COUNTS)
    y = su.ssd_update(*args, groups=2)
    assert torch.equal(y, want_y)
    assert torch.equal(h, want_h.to(h.dtype))
    assert COUNTS == before


def _step_as_it_was(x, p, cfg, cache):
    """``ssm.ssd_decode`` un-meshed as it ran before the update became a
    kernel: the conv window, the recurrence above, the new state copied
    into the cache."""
    z, xbc, dt_raw = ssm._split_proj(x[:, 0], p["in_proj"], cfg)
    tail = cache["conv"]
    win = torch.cat([tail.to(xbc.dtype), xbc[:, None]], dim=1)
    conv_out = (win * p["conv_w"][None]).sum(dim=1) + p["conv_b"]
    xbc = F.silu(conv_out.float()).to(win.dtype)
    y, hstate = _recurrence_as_it_was(xbc, dt_raw, p["dt_bias"], p["a_log"],
                                      p["d_skip"], cache["h"],
                                      cfg.ssm_groups)
    cache["h"].copy_(hstate)
    cache["conv"].copy_(win[:, 1:])
    z = F.silu(z.float()).to(x.dtype)
    y = ssm._gated_norm(y * z, p["norm_w"], cfg)
    return (y @ p["out_proj"])[:, None, :]


@pytest.mark.parametrize("arch,groups", [("zamba2-7b", 1), ("zamba2-7b", 2),
                                         ("mamba2-2.7b", 1)])
def test_the_decode_step_on_the_cpu_is_unchanged_bit_for_bit(arch, groups):
    """Three steps of ``ssm.ssd_decode`` from one cache against the step
    as it was, in the parameters' own dtype: the same output, state and
    conv window to the bit, the state updated in its own storage, one
    update counted a step and no kernel launch."""
    api = registry.get_reduced(arch)
    cfg = dataclasses.replace(api.cfg, ssm_groups=groups) \
        if api.cfg.family == "zamba2" else api.cfg
    _three_steps_as_they_were(registry.ModelApi(cfg=cfg, module=api.module))


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-2.7b"])
def test_the_decode_step_on_the_cpu_takes_a_state_width_the_kernel_does_not(
        arch):
    """At a state width of 8, which the kernel is not built for, the CPU
    step still runs and equals the step as it was."""
    api = registry.get_reduced(arch)
    cfg = dataclasses.replace(api.cfg, ssm_state=8)
    _three_steps_as_they_were(registry.ModelApi(cfg=cfg, module=api.module))


def _three_steps_as_they_were(api):
    cfg = api.cfg
    params = api.init_params(7, device="cpu")
    layers = params["mamba"] if cfg.family == "zamba2" else params["layers"]
    lp = {k: v[0] for k, v in layers["mixer"].items()}
    gen = torch.Generator().manual_seed(9)
    b = 3
    cache = ssm.ssm_init_cache(cfg, b, device="cpu")
    cache["h"].normal_(0, 0.05, generator=gen)
    cache["conv"].copy_(torch.randn(cache["conv"].shape, generator=gen))
    mine = {k: v.clone() for k, v in cache.items()}
    ptr = cache["h"].data_ptr()
    dtype = lp["in_proj"].dtype
    before = dict(COUNTS)
    for step in range(3):
        x = torch.randn((b, 1, cfg.d_model), generator=gen).to(dtype)
        got = ssm.ssd_decode(x, lp, cfg, cache)
        want = _step_as_it_was(x, lp, cfg, mine)
        assert torch.equal(got, want), step
        assert torch.equal(cache["h"], mine["h"]), step
        assert torch.equal(cache["conv"], mine["conv"]), step
    assert cache["h"].data_ptr() == ptr
    # three updates, no launch: the plain path never counts
    assert COUNTS == dict(before, ssm_update=before["ssm_update"] + 3)


def test_the_graph_steps_counters_name_the_kernels_launches():
    """``launches_per_replay`` takes its names from ``step_counters``: the
    kernel's launches are counted beside the updates."""
    from repro_torch.launch import steps
    counters = steps.step_counters()
    assert counters["ssd_update_kernel"] == COUNTS["ssd_update_kernel"]
    assert "ssm_update" in counters


# ------------------------------------------------------- the readers

CHAT = {"hybrid_layer_ids": [6, 11], "num_hidden_layers": 81,
        "hidden_size": 3584, "mamba_expand": 2, "mamba_headdim": 64,
        "mamba_ngroups": 2, "mamba_d_state": 64, "mamba_d_conv": 4,
        "num_attention_heads": 32, "num_key_value_heads": 32,
        "intermediate_size": 14336, "adapter_rank": 128,
        "num_mem_blocks": 2, "vocab_size": 32000}
STATE_BYTES = 2 * 64 * 112 * 64 * 64 * 4          # a layer's, read + write


def _chat_run(per, kernel_us=None, steps=2, events=None):
    events = events if events is not None else (
        81 * steps if kernel_us else 0)
    trace = DeviceTrace(
        [{"ph": "X", "cat": "kernel",
          "name": "void (anonymous namespace)::ssd_update_kernel<64, "
                  "__nv_bfloat16>(float*)",
          "ts": 10.0 * i, "dur": kernel_us} for i in range(events)]
        + [{"ph": "X", "cat": "kernel", "name": "flash_decode_split_kernel",
            "ts": 1e6, "dur": 50.0}], 1.0)
    return types.SimpleNamespace(
        info={"model": CHAT, "batch": 64, "launches_per_replay": per},
        trace=trace, traced={"steps": steps}, window={}, spans={})


def test_the_kernel_share_reads_the_capture_counters():
    reader = spec.metric_reader("ssd_kernel_share.chat", BENCH)
    full = {"ssm_update": 81, "ssd_update_kernel": 81, "flash_decode": 13}
    assert reader.read(_chat_run(full)) == pytest.approx(100.0)
    assert reader.read(_chat_run(dict(full, ssd_update_kernel=27))) == \
        pytest.approx(100.0 / 3)
    # a program without the counter (the parent's), or no update at all
    assert reader.read(_chat_run({"ssm_update": 81})) is None
    assert reader.read(_chat_run({"ssm_update": 0,
                                  "ssd_update_kernel": 0})) is None


def test_the_roofline_reads_the_state_bytes_over_the_kernels_time():
    """81 launches a replay over 2 traced steps at 100 us each: the least
    time is a layer's state read and written once at 3.35 TB/s (70.1 us),
    so the share is 70.1 %; with half the events dropped by the profiler
    the mean of those seen stands for every launch made."""
    reader = spec.metric_reader("ssd_update_roofline.chat", BENCH)
    per = {"ssm_update": 81, "ssd_update_kernel": 81}
    want = STATE_BYTES / 3.35e12 / 100e-6 * 100
    assert reader.read(_chat_run(per, 100.0)) == pytest.approx(want)
    assert reader.read(_chat_run(per, 100.0, events=81)) == \
        pytest.approx(want)
    assert reader.read(_chat_run({"ssm_update": 81}, 100.0)) is None
    assert reader.read(_chat_run(per)) is None       # no kernel traced
    run = _chat_run(per, 100.0)
    run.trace = None
    assert reader.read(run) is None


# ------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bfloat16 at each of ``v``'s values
    (8 bits of mantissa); the smallest normal's at zero."""
    _, e = torch.frexp(v.float())
    e = torch.where(v == 0, torch.full_like(e, -125), e)
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


# Zamba2-7B (B 64, H 112, P 64, N 64, G 2), Mamba2-2.7B (H 80, N 128,
# G 1), and the reduced configs' P 16 with each other width.
CARD_SHAPES = {"zamba2-7b": (64, 112, 64, 64, 2),
               "mamba2-2.7b": (16, 80, 64, 128, 1),
               "reduced_n16": (3, 8, 16, 16, 2),
               "reduced_n32": (3, 8, 16, 32, 4)}


def _sum_error_bound(args, h_new, groups):
    """How far two float32 sums of each output of the read-out, taken in
    any two orders, may lie apart: 2 (N + 1) 2^-24 times the sum of the
    terms' magnitudes, ``sum_n |C_n h_n| + |x D|`` (a recursive sum of
    N + 1 terms errs by at most N + 1 roundings of that, each side)."""
    xbc, _, _, _, d_skip, _ = args
    b, heads, p, n = h_new.shape
    hg = heads // groups
    x = xbc[:, :heads * p].float().view(b, groups, hg, p)
    c = xbc[:, heads * p + groups * n:].float().view(b, groups, n)
    mag = torch.einsum("bgn,bghpn->bghp", c.abs(),
                       h_new.view(b, groups, hg, p, n).abs())
    mag = mag + (x * d_skip.view(groups, hg, 1)).abs()
    return 2 * (n + 1) * 2.0 ** -24 * mag.reshape(b, heads * p)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_the_kernel_matches_its_plain_version(card, shape, dtype):
    """The state to 2 roundings of float32 (1e-6 relative, with 1e-6 of
    the state's largest entry where the decayed state and the new term
    cancel): each entry is the same products and sum, each rounded as
    PyTorch rounds it, but the plain version's einsum may group
    dt * x * B otherwise.  ``y`` within one bfloat16 ulp of the plain
    version's (none in float32) beyond what the order of the float32 sum
    over N may move it (:func:`_sum_error_bound`): the kernel sums in a
    shuffle tree, not in cuBLAS's order, so where the terms cancel to
    near zero the two sums may lie further apart than a bfloat16 ulp of
    the result."""
    b, heads, p, n, groups = CARD_SHAPES[shape]
    args = _inputs(11, b, heads, p, n, groups, dtype, card)
    h = args[-1]
    want_y, want_h = su.ssd_update_plain(*args, groups=groups)
    before = COUNTS["ssd_update_kernel"]
    y = su.ssd_update(*args, groups=groups)
    torch.cuda.synchronize()
    assert COUNTS["ssd_update_kernel"] == before + 1
    assert y.dtype == dtype and y.shape == (b, heads * p)
    scale = want_h.abs().max().item()
    torch.testing.assert_close(h, want_h, rtol=1e-6, atol=1e-6 * scale)
    tol = _sum_error_bound(args, want_h, groups)
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(want_y)
    gap = (y.float() - want_y.float()).abs()
    assert (gap <= tol).all(), (gap - tol).max().item()


@pytest.mark.gpu
def test_the_kernel_writes_its_layer_of_a_stacked_state_and_nothing_else(
        card):
    """The state is one layer's view of a stacked cache: the kernel
    updates it in its own storage (same data pointer), and leaves the
    layers beside it, its inputs and its constants as they were."""
    b, heads, p, n, groups = 4, 16, 64, 64, 2
    args = _inputs(12, b, heads, p, n, groups, torch.bfloat16, card)
    stacked = torch.randn((3, b, heads, p, n), device=card)
    stacked[1].copy_(args[-1])
    args[-1] = stacked[1]
    others = stacked[[0, 2]].clone()
    inputs = [t.clone() for t in args[:-1]]
    ptr = args[-1].data_ptr()
    _, want_h = su.ssd_update_plain(*args, groups=groups)
    su.ssd_update(*args, groups=groups)
    torch.cuda.synchronize()
    assert args[-1].data_ptr() == ptr
    torch.testing.assert_close(stacked[1], want_h, rtol=1e-6,
                               atol=1e-6 * want_h.abs().max().item())
    assert torch.equal(stacked[[0, 2]], others)
    for got, was in zip(args[:-1], inputs):
        assert torch.equal(got, was)


@pytest.mark.gpu
def test_the_kernel_refuses_a_misaligned_state(card):
    args = _inputs(13, 2, 8, 16, 16, 2, torch.bfloat16, card)
    flat = torch.zeros(args[-1].numel() + 1, device=card)
    args[-1] = flat[1:].view(args[-1].shape)
    with pytest.raises(KernelShapeError, match="16 bytes"):
        su.ssd_update(*args, groups=2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_refusals()))
def test_the_wrapper_refuses_on_the_card_what_the_kernel_does_not_take(
        card, case):
    """On CUDA tensors the wrapper raises and launches nothing: it never
    gives way to the plain version."""
    edit, match = _refusals()[case]
    args = _inputs(14, 2, 8, 16, 16, 2, torch.bfloat16, card)
    edit(args)
    before = dict(COUNTS)
    with pytest.raises(KernelShapeError, match=match):
        su.ssd_update(*args, groups=2)
    assert COUNTS == before
