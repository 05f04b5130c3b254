"""The port's decode attention (K5) against the JAX package, on the CPU: the
same numpy inputs go through ``repro`` (Pallas ``flash_decode``, interpret
mode; ``ops.decode_attention``) and through ``repro_torch`` (on CPU tensors
the wrapper runs ``decode_attention_plain``, the same online softmax over
the KV blocks in order).

Tolerances.  float32: ``rtol = atol = 1e-4`` — both sides compute the
scores, the softmax and the weighted sum in f32, in another order.
bfloat16 (inputs bf16, arithmetic f32 on both sides, one final rounding):
``rtol = 1.6e-2, atol = 1e-2``, one unit in the last place.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro.kernels import flash_decode as jfd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import planner
from repro_torch.core.cost_model import H100_SXM
from repro_torch.kernels import KernelShapeError, ops, ref
from repro_torch.kernels import flash_decode as fd

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=1.6e-2, atol=1e-2)}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# tests/test_kernels.py:84-89
CASES = [
    (1, 4, 4, 32, 128, 64),       # MHA
    (2, 8, 2, 64, 256, 64),       # GQA 4:1
    (2, 8, 1, 64, 256, 128),      # MQA
    (1, 16, 4, 128, 512, 256),
]


def _arrays(seed, b, hq, hkv, d, s, min_len=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    lengths = rng.integers(min_len, s + 1, size=(b,)).astype(np.int32)
    return q, k, v, lengths


def _torch(x, dtype="float32"):
    t = torch.from_numpy(x)
    return t if x.dtype == np.int32 else t.to(TORCH_DTYPE[dtype])


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, dtype):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def _oracle(q, k, v, lengths):
    """``ref.decode_attention`` of the JAX package, head by head."""
    b, hq, _ = q.shape
    g = hq // k.shape[2]
    return np.stack([np.stack([np.asarray(jref.decode_attention(
        jnp.asarray(q[bi, h:h + 1]), jnp.asarray(k[bi, :, h // g]),
        jnp.asarray(v[bi, :, h // g]), int(lengths[bi]))[0])
        for h in range(hq)]) for bi in range(b)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,d,s,bkv", CASES)
def test_decode_matches_the_jax_kernel_and_ops(b, hq, hkv, d, s, bkv,
                                               dtype):
    q, k, v, lengths = _arrays(60, b, hq, hkv, d, s)
    qt, kt, vt = _torch(q, dtype), _torch(k, dtype), _torch(v, dtype)
    out = fd.decode_attention(qt, kt, vt, _torch(lengths), bkv=bkv)
    assert out.dtype == TORCH_DTYPE[dtype] and tuple(out.shape) == q.shape
    qj, kj, vj = (jnp.asarray(x, JAX_DTYPE[dtype]) for x in (q, k, v))
    _close(out, jops.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                      bkv=bkv), dtype)
    # the kernel-level JAX function on one (b, KV head): G query rows
    g = hq // hkv
    one = jfd.decode_attention(qj[0, :g], kj[0, :, 0], vj[0, :, 0],
                               int(lengths[0]), bkv=bkv, interpret=True)
    _close(out[0, :g], one, dtype)
    _close(ops.decode_attention(qt, kt, vt, _torch(lengths), bkv=bkv), out,
           dtype)


@pytest.mark.parametrize("b,hq,hkv,d,s,bkv", CASES)
def test_decode_matches_the_oracles(b, hq, hkv, d, s, bkv):
    q, k, v, lengths = _arrays(61, b, hq, hkv, d, s)
    out = ops.decode_attention(_torch(q), _torch(k), _torch(v),
                               _torch(lengths), bkv=bkv)
    _close(out, _oracle(q, k, v, lengths), "float32")
    g = hq // hkv
    for bi in range(b):
        for h in range(hq):
            want = ref.decode_attention(
                _torch(q[bi, h:h + 1]), _torch(k[bi, :, h // g]),
                _torch(v[bi, :, h // g]), int(lengths[bi]))[0]
            _close(out[bi, h], want, "float32")


def test_full_length_is_the_default():
    q, k, v, _ = _arrays(62, 1, 4, 4, 32, 128)
    out = ops.decode_attention(_torch(q), _torch(k), _torch(v), bkv=32)
    full = ops.decode_attention(_torch(q), _torch(k), _torch(v),
                                torch.tensor([128], dtype=torch.int32),
                                bkv=32)
    assert torch.equal(out, full)


def test_empty_cache_gives_the_mean_of_v_as_the_tpu_kernel_does():
    """``length == 0``: every score is masked to -1e30, so p = 1 for all S
    rows and the result is the plain mean of v (the TPU kernel's answer;
    the -inf oracles give NaN)."""
    q, k, v, _ = _arrays(63, 2, 8, 2, 32, 64)
    lengths = np.array([0, 5], np.int32)
    out = fd.decode_attention(_torch(q), _torch(k), _torch(v),
                              _torch(lengths), bkv=32)
    mean_v = v[0].mean(axis=0).repeat(4, axis=0)          # (H_q, D)
    np.testing.assert_allclose(out[0].numpy(), mean_v, rtol=1e-5, atol=1e-5)
    j = jfd.decode_attention(jnp.asarray(q[0, :4]), jnp.asarray(k[0, :, 0]),
                             jnp.asarray(v[0, :, 0]), 0, bkv=32,
                             interpret=True)
    np.testing.assert_allclose(out[0, :4].numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)
    assert bool(torch.isnan(ref.decode_attention(
        _torch(q[0, :4]), _torch(k[0, :, 0]), _torch(v[0, :, 0]), 0)).all())
    _close(out[1], _oracle(q, k, v, lengths)[1], "float32")


@pytest.mark.parametrize("s", [48, 200])
def test_cache_lengths_the_reference_cannot_plan(s):
    """The reference's planner tries only power-of-two blocks that divide S
    and raises for S = 48 or 200; the port plans Hopper-sized blocks
    (capped at S) and agrees with the oracle."""
    q, k, v, lengths = _arrays(64, 2, 8, 2, 32, s)
    with pytest.raises(ValueError, match="no KV block"):
        jops.decode_attention(q, k, v, jnp.asarray(lengths))
    out = ops.decode_attention(_torch(q), _torch(k), _torch(v),
                               _torch(lengths))
    _close(out, _oracle(q, k, v, lengths), "float32")


def test_a_block_that_does_not_divide_s_pads_the_cache():
    """bkv = 32 over S = 48: the cache is padded with zero rows to 64,
    which the lengths mask hides."""
    q, k, v, lengths = _arrays(65, 2, 8, 2, 32, 48)
    out = ops.decode_attention(_torch(q), _torch(k), _torch(v),
                               _torch(lengths), bkv=32)
    _close(out, _oracle(q, k, v, lengths), "float32")
    with pytest.raises(KernelShapeError, match="multiple of bkv"):
        fd.decode_attention(_torch(q), _torch(k), _torch(v),
                            _torch(lengths), bkv=32)


def test_a_strided_cache_is_read_in_place():
    """A layer of a stacked cache, and a prefix of a longer one, as
    views: no copy is needed."""
    q, k, v, lengths = _arrays(66, 2, 8, 2, 32, 64)
    big_k = torch.zeros((3, 2, 96, 2, 32))
    big_v = torch.zeros((3, 2, 96, 2, 32))
    big_k[1, :, :64], big_v[1, :, :64] = _torch(k), _torch(v)
    kt, vt = big_k[1, :, :64], big_v[1, :, :64]
    assert not kt.is_contiguous()
    out = fd.decode_attention(_torch(q), kt, vt, _torch(lengths), bkv=32)
    _close(out, _oracle(q, k, v, lengths), "float32")


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("s,d,g", [(512, 64, 8), (4096, 64, 8),
                                   (32768, 128, 8), (48, 32, 4),
                                   (200, 64, 16)])
def test_plan_decode_attention_fits_the_h100_budget(s, d, g, dtype_bytes):
    p = planner.plan_decode_attention(s, d, g, dtype_bytes)
    bkv = p.tiles["bkv"]
    assert bkv % 16 == 0
    assert p.smem_bytes == planner.decode_smem_bytes(
        g, d, p.tiles["tile"], p.tiles["stages"], p.tiles["warps"],
        dtype_bytes)
    assert p.smem_bytes <= H100_SXM.smem_bytes_per_block
    # decode is memory-bound: the bytes set the duration
    assert p.duration_overlapped == p.hbm_bytes / H100_SXM.hbm_bw
    if s % 16 == 0:
        assert s % bkv == 0          # a block that divides S costs no pad


def test_shape_errors_are_typed():
    q = torch.zeros((1, 4, 32))
    kv = torch.zeros((1, 128, 1, 16))
    lengths = torch.tensor([128], dtype=torch.int32)
    with pytest.raises(KernelShapeError):      # head-dim mismatch
        fd.decode_attention(q, kv, kv, lengths, bkv=64)
    kv = torch.zeros((1, 128, 3, 32))
    with pytest.raises(KernelShapeError, match="divisible"):
        ops.decode_attention(q, kv, kv, lengths)
    kv = torch.zeros((1, 128, 2, 32))
    with pytest.raises(KernelShapeError, match="int32"):
        fd.decode_attention(q, kv, kv, lengths.long(), bkv=64)
    with pytest.raises(KernelShapeError, match="multiple of bkv"):
        fd.decode_specs(2, 32, 100, 64)


# --------------------------------------------------------------------- #
# The split kernel and its combine: plain versions against the JAX kernel
# --------------------------------------------------------------------- #

SPLIT_S, SPLIT_BKV = 128, 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [2, 4, 8])
def test_split_then_combine_matches_the_jax_kernel(splits, dtype):
    """The cache cut into ``splits`` ranges, each walked on its own, the
    partials combined: per ``(b, kv_head)`` the JAX kernel's answer
    (Pallas, interpret mode) at lengths 0, 1, one range, one row past a
    range, and S.  Tolerances as for the walk (module docstring): the
    combine rescales f32 partials, another order of the same f32 sums;
    bf16 results differ by their one final rounding."""
    rng_len = SPLIT_S // splits
    lengths = np.array([0, 1, rng_len, rng_len + 1, SPLIT_S], np.int32)
    q, k, v, _ = _arrays(70 + splits, 5, 8, 2, 32, SPLIT_S)
    qt, kt, vt = _torch(q, dtype), _torch(k, dtype), _torch(v, dtype)
    out = fd.decode_attention(qt, kt, vt, _torch(lengths), bkv=SPLIT_BKV,
                              splits=splits)
    assert out.dtype == TORCH_DTYPE[dtype] and tuple(out.shape) == q.shape
    qj, kj, vj = (jnp.asarray(x, JAX_DTYPE[dtype]) for x in (q, k, v))
    g = 4
    for bi in range(5):
        for kvh in range(2):
            want = jfd.decode_attention(
                qj[bi, kvh * g:(kvh + 1) * g], kj[bi, :, kvh],
                vj[bi, :, kvh], int(lengths[bi]), bkv=SPLIT_BKV,
                interpret=True)
            _close(out[bi, kvh * g:(kvh + 1) * g], want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,d", [(2, 2, 80), (24, 2, 48)])
def test_split_then_combine_matches_the_jax_kernel_at_wide_shapes(hq, hkv, d,
                                                                  dtype):
    """Zamba2-2.7B's head dim of 80 and G = 12 query rows per KV head (more
    than one block of the split kernel holds): the plain split-then-combine
    against the JAX kernel (interpret mode), four splits, at lengths 0,
    one past a range, and S.  Tolerances as above."""
    lengths = np.array([0, SPLIT_S // 4 + 1, SPLIT_S], np.int32)
    q, k, v, _ = _arrays(78 + d, 3, hq, hkv, d, SPLIT_S)
    out = fd.decode_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), _torch(lengths),
                              bkv=SPLIT_BKV, splits=4)
    qj, kj, vj = (jnp.asarray(x, JAX_DTYPE[dtype]) for x in (q, k, v))
    g = hq // hkv
    for bi in range(3):
        for kvh in range(hkv):
            want = jfd.decode_attention(
                qj[bi, kvh * g:(kvh + 1) * g], kj[bi, :, kvh],
                vj[bi, :, kvh], int(lengths[bi]), bkv=SPLIT_BKV,
                interpret=True)
            _close(out[bi, kvh * g:(kvh + 1) * g], want, dtype)


@pytest.mark.parametrize("dtype,d,takes", [
    (torch.bfloat16, 80, True), (torch.float32, 80, True),
    (torch.bfloat16, 256, True), (torch.float32, 128, True),
    (torch.bfloat16, 36, False), (torch.float32, 256, False)])
def test_the_split_kernel_takes_head_dims_of_16_byte_vectors(dtype, d,
                                                             takes):
    """What the CUDA kernel takes, checked before a launch: a head dim of
    whole 16-byte vectors, at most 32 of them (a warp per row; the lanes
    are rounded up to a power of two), and any number of query rows."""
    q = torch.zeros((1, 16, d), dtype=dtype)
    kv = torch.zeros((1, 64, 1, d), dtype=dtype)
    lengths = torch.tensor([64], dtype=torch.int32)
    if takes:
        fd._check_for_the_kernels(q, kv, kv, lengths, 16, d, 32)
    else:
        with pytest.raises(KernelShapeError, match="head dim"):
            fd._check_for_the_kernels(q, kv, kv, lengths, 16, d, 32)


def _slots(p, g: int) -> int:
    """Blocks of the plan's ring the card holds at once, G query rows a
    KV head."""
    return H100_SXM.n_sms * planner.decode_blocks_per_sm(
        p.smem_bytes, p.tiles["warps"], planner.decode_regs(g))


def test_the_split_rule_gives_a_block_to_every_eight_query_rows():
    """G = 16 takes two blocks per range, each with the scores and the
    merge buffer of 8 rows; the rule counts them in the grid it sizes,
    which stays within the card's resident slots and leaves no warp of a
    block without a tile."""
    for ring in ((16, 3, 4), (8, 2, 8)):
        assert planner.decode_smem_bytes(16, 64, *ring, 2) == \
            planner.decode_smem_bytes(8, 64, *ring, 2)
    p = planner.plan_decode_split(512, 64, 16, 16, 2)
    assert 2 * 16 * p.tiles["splits"] <= _slots(p, 16)
    assert 512 // p.tiles["splits"] >= p.tiles["tile"] * p.tiles["warps"]


def test_partials_of_a_range_past_the_length_carry_no_weight():
    """A range wholly past a length >= 1 holds (acc, m, l) = (0, -1e30, 0),
    as the kernel writes it without reading its rows; at length 0 every
    range holds all its rows at m = -1e30 (the mean of v)."""
    q, k, v, _ = _arrays(75, 2, 4, 1, 32, 64)
    lengths = torch.tensor([17, 0], dtype=torch.int32)
    part = fd.decode_partials_plain(_torch(q), _torch(k), _torch(v),
                                    lengths, bkv=16, splits=4)
    assert tuple(part.shape) == (2, 1, 4, 4, 34)
    # b = 0: ranges 0 and 1 hold rows below 17, ranges 2 and 3 none
    assert bool((part[0, 0, 2:, :, :32] == 0).all())
    assert bool((part[0, 0, 2:, :, 32] == -1e30).all())
    assert bool((part[0, 0, 2:, :, 33] == 0).all())
    assert bool((part[0, 0, :2, :, 32] > -1e30).all())
    assert bool((part[0, 0, 1, :, 33] == 1).all())   # row 16 alone: p = 1
    # b = 1: every range masked whole, 16 rows of p = 1 each
    assert bool((part[1, 0, :, :, 32] == -1e30).all())
    assert bool((part[1, 0, :, :, 33] == 16).all())
    out = fd.decode_combine(part, torch.float32)
    np.testing.assert_allclose(out[1].numpy(),
                               np.repeat(v[1].mean(axis=0), 4, axis=0),
                               rtol=1e-5, atol=1e-5)
    _close(out[0], _oracle(q, k, v, lengths.numpy())[0], "float32")


@pytest.mark.parametrize("splits", [1, 2, 8])
def test_one_split_is_the_walk_and_more_agree_with_it(splits):
    """With one split the pair is the TPU kernel's walk, bit for bit (the
    combine of one partial divides the same acc by the same l); with more,
    the same result within the f32 tolerance."""
    q, k, v, lengths = _arrays(76, 3, 8, 2, 32, 256, min_len=0)
    args = (_torch(q), _torch(k), _torch(v), _torch(lengths))
    walk = fd.decode_attention_plain(*args, bkv=32)
    got = fd.decode_attention_plain(*args, bkv=32, splits=splits)
    if splits == 1:
        assert torch.equal(got, walk)
    _close(got, walk, "float32")
    _close(fd.decode_attention(*args, bkv=32, splits=splits), got,
           "float32")


def test_the_split_rule_fills_the_card_at_tinyllamas_serving_shape():
    """B = 4 sequences x 4 KV heads are 16 blocks without a split: the rule
    cuts each cache into ranges while the grid fits the card's resident
    slots and every warp of a block keeps a tile (S = 512: 8 ranges of
    one tile a warp; S = 4096: 32 ranges, 512 of the 528 slots), and the
    partials' round trip keeps it from going further."""
    for s, splits in ((512, 8), (4096, 32)):
        p = planner.plan_decode_split(s, 64, 8, 16, 2)
        assert p.tiles["splits"] == splits
        assert 16 * splits <= _slots(p, 8)
        rng = s // splits
        assert rng % p.tiles["bkv"] == 0 and p.tiles["bkv"] % 16 == 0
        assert rng >= p.tiles["tile"] * p.tiles["warps"]
        assert p.smem_bytes == planner.decode_smem_bytes(
            8, 64, p.tiles["tile"], p.tiles["stages"], p.tiles["warps"],
            2) <= H100_SXM.smem_bytes_per_block
    # more splits than the slots hold only add waves and partials: a grid
    # of 1024 heads, past the 528 slots already, is never split
    assert planner.plan_decode_split(4096, 64, 8, 1024, 2).tiles["splits"] \
        == 1


@pytest.mark.parametrize("s", [16, 8])
def test_the_split_rule_keeps_one_range_where_one_is_all_there_is(s):
    """A cache of at most 16 rows is one KV block: one split, no combine."""
    p = planner.plan_decode_split(s, 64, 8, 16, 2)
    assert (p.tiles["bkv"], p.tiles["splits"]) == (16, 1)


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("s,d,g,heads", [(512, 64, 8, 16), (4096, 64, 8, 16),
                                         (32768, 128, 8, 2), (48, 32, 4, 4),
                                         (200, 64, 8, 1)])
def test_the_split_rule_fits_one_block_and_pads_to_its_grain(s, d, g, heads,
                                                            dtype_bytes):
    p = planner.plan_decode_split(s, d, g, heads, dtype_bytes)
    bkv, splits = p.tiles["bkv"], p.tiles["splits"]
    assert p.smem_bytes == planner.decode_smem_bytes(
        g, d, p.tiles["tile"], p.tiles["stages"], p.tiles["warps"],
        dtype_bytes)
    assert p.smem_bytes <= H100_SXM.smem_bytes_per_block
    padded = -(-s // (bkv * splits)) * bkv * splits
    assert padded - s < bkv * splits
    assert splits == 1 or heads * -(-g // 8) * splits <= _slots(p, g)
    # ops pads to the rule's grain and gets the oracle's answer
    if s <= 512:
        q, k, v, lengths = _arrays(77, 1, g, 1, d, s)
        out = ops.decode_attention(_torch(q), _torch(k), _torch(v),
                                   _torch(lengths))
        _close(out, _oracle(q, k, v, lengths), "float32")


# The decode cells' shapes, (context + generated rows, D, G, B x H_kv):
# Qwen2-7B's long and short cells (B 32, 28/4 heads of 128), Zamba2-7B's
# chat cell (B 64, 32 heads of 224 over 32 KV heads)
CELL_SHAPES = {"qwen2-7b.decode.long": (8192 + 256, 128, 7, 32 * 4),
               "qwen2-7b.decode.short": (512 + 256, 128, 7, 32 * 4),
               "zamba2-7b.decode.chat": (512 + 256, 224, 1, 64 * 32)}


@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
def test_the_split_rule_keeps_sixteen_warps_resident_at_the_cells_shapes(
        cell):
    """The ring at the decode cells' shapes: at least 16 warps resident an
    SM by shared memory and registers (128 a thread at G 7, 80 at G 1), the block within one block's
    shared memory, tiles of 8 rows where the scores run on the tensor
    cores (G 7 in bf16), some 64 KB of the cache or more in flight an SM
    (``stages - 1`` tiles a warp), a split grid within the slots, and the
    grain (``splits x bkv``) dividing the cache ``ops.decode_cache_rows``
    gives, so the kernel reads it in place."""
    s, d, g, heads = CELL_SHAPES[cell]
    p = planner.plan_decode_split(s, d, g, heads, 2)
    t = p.tiles
    assert t == dict(t, **planner.decode_ring(g, d, 2))
    assert p.smem_bytes == planner.decode_smem_bytes(
        g, d, t["tile"], t["stages"], t["warps"], 2)
    assert p.smem_bytes <= H100_SXM.smem_bytes_per_block
    regs = planner.decode_regs(g)
    assert regs == (128 if g > 2 else 80)
    blocks = planner.decode_blocks_per_sm(p.smem_bytes, t["warps"], regs)
    assert blocks * t["warps"] >= 16
    assert blocks * (p.smem_bytes + H100_SXM.smem_reserved_per_block) \
        <= H100_SXM.smem_bytes_per_sm
    assert blocks * t["warps"] * 32 * regs <= H100_SXM.regs_per_sm
    assert planner.decode_mma(g, d, 2) == (g >= 2)
    assert not planner.decode_mma(g, d, 2) or t["tile"] % 8 == 0
    in_flight = blocks * t["warps"] * (t["stages"] - 1) * t["tile"] \
        * 2 * d * 2
    assert in_flight >= 64 * 1024
    assert t["splits"] == 1 or heads * t["splits"] <= _slots(p, g)
    rows = ops.decode_cache_rows(s, d, g, heads, 2)
    assert rows % (t["bkv"] * t["splits"]) == 0 and rows - s < 16 * t[
        "splits"]


@pytest.mark.parametrize("g,d,kv_bytes,mma", [
    (7, 128, 2, True), (8, 64, 2, True), (2, 80, 2, True),
    (1, 224, 2, False), (8, 128, 4, False), (4, 40, 2, False)])
def test_the_ring_takes_tiles_of_eight_where_the_tensor_cores_score(
        g, d, kv_bytes, mma):
    """Tensor-core scores come with a bf16 cache, G >= 2 and D a multiple
    of 16, and then the ring's tile is a multiple of the MMA's 8 rows;
    every ring fits one block."""
    assert planner.decode_mma(g, d, kv_bytes) == mma
    r = planner.decode_ring(g, d, kv_bytes)
    assert r["tile"] in planner.DECODE_TILES
    assert r["stages"] in planner.DECODE_STAGES
    assert not mma or r["tile"] % 8 == 0
    assert planner.decode_smem_bytes(g, d, r["tile"], r["stages"],
                                     r["warps"], kv_bytes) \
        <= H100_SXM.smem_bytes_per_block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_shards_partials_gathered_and_combined_match_the_jax_ops(shards,
                                                                 dtype):
    """A cache whose sequence is split over ``shards`` devices as DTensor
    splits it (chunks of ceil(S / shards) rows; 3 is uneven): each shard's
    ``ops.decode_partials`` over its own rows, its lengths counted from
    its first row (0 for a shard wholly past them), planned for the
    largest shard's rows; the partials side by side along dim 2 and
    ``ops.decode_combine``: the JAX package's ``ops.decode_attention`` of
    the whole cache, within the module's tolerances."""
    s = 256
    q, k, v, _ = _arrays(90 + shards, 5, 8, 2, 64, s)
    lengths = np.array([1, 40, 86, 172, s], np.int32)
    qt, kt, vt = _torch(q, dtype), _torch(k, dtype), _torch(v, dtype)
    rows = -(-s // shards)
    parts = []
    for start in range(0, s, rows):
        kl, vl = kt[:, start:start + rows], vt[:, start:start + rows]
        local = (_torch(lengths) - start).clamp(0, kl.shape[1]).to(
            torch.int32)
        parts.append(ops.decode_partials(qt, kl, vl, local, rows=rows))
    assert len({p.shape for p in parts}) == 1
    out = ops.decode_combine(torch.cat(parts, dim=2), qt.dtype)
    assert out.dtype == TORCH_DTYPE[dtype] and tuple(out.shape) == q.shape
    qj, kj, vj = (jnp.asarray(x, JAX_DTYPE[dtype]) for x in (q, k, v))
    _close(out, jops.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                      bkv=64), dtype)
