"""The port's optimizer, gradient compression and data pipeline against
the JAX package's, on the CPU: one ``adamw.update`` on the same arrays
(float32 and bfloat16 parameters), ``ErrorFeedbackInt8`` bit for bit,
``RandomK``'s properties (its masks come from a ``torch.Generator``, not
``jax.random``), ``Pipeline`` batches equal to the reference's; and the
JAX package's own cases of them (``tests/test_substrates.py``), mirrored.

Tolerance of one AdamW step: both packages compute it in float32 in the
same order of operations; ``b ** step`` and the square root may round
apart by an ulp in XLA and in PyTorch, so the float32 parameters and
moments are held to 1e-6 relative (atol 1e-7 for moments near 0), and a
bfloat16 parameter to one unit in its last place where the two float32
results straddle a rounding boundary."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import Pipeline as JPipeline
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as jadamw
from repro.optim.compression import ErrorFeedbackInt8 as JInt8
from repro_torch.data.pipeline import DataConfig, Pipeline, SyntheticLM
from repro_torch.models.common import leaves
from repro_torch.optim import adamw
from repro_torch.optim.compression import ErrorFeedbackInt8, RandomK


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((8, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)
                  * 3}}


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype):
    return {k: _torch(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(v).to(dtype) for k, v in tree.items()}


# ---------------------------- optimizer -------------------------------- #

@pytest.mark.parametrize("clip", [1.0, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype, clip):
    """Three updates from the same parameters, gradients and state: the
    parameters (in their dtype), both float32 moments, the step and the
    pre-clip norm against the JAX package's (clip 1.0 scales the
    gradients, 100 does not)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    jp, p = _jax(_tree(0, dtype), jdt), _torch(_tree(0, dtype), tdt)
    jst, st = jadamw.init(jp), adamw.init(p)
    for i in range(3):
        g = _tree(10 + i, dtype)
        jp, jst, jn = jadamw.update(jp, _jax(g, jnp.float32), jst,
                                    jadamw.AdamWConfig(**cfg))
        p, st, n = adamw.update(p, _torch(g, torch.float32), st,
                                adamw.AdamWConfig(**cfg))
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
    assert int(st["step"]) == int(jst["step"]) == 3
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    for got, want in zip(leaves(p), jax.tree.leaves(jp), strict=True):
        assert got.dtype == tdt
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        else:
            ulp = np.abs(want) * 2.0 ** -7
            assert (np.abs(got.float().numpy() - want) <= ulp).all()
    for name in ("m", "v"):
        for got, want in zip(leaves(st[name]), jax.tree.leaves(jst[name]),
                             strict=True):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


def test_adamw_keeps_float32_moments_for_bfloat16_parameters():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    st = adamw.init(p)
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32
    p2, st2, _ = adamw.update(p, {"w": torch.full((3,), 1e-3)}, st,
                              adamw.AdamWConfig(lr=1e-3))
    assert p2["w"].dtype == torch.bfloat16 and p2["w"] is p["w"]
    assert st2["m"]["w"].abs().min() > 0          # not flushed in bf16


def test_adamw_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0)
    params = {"w": torch.tensor([4.0, -4.0])}
    state = adamw.init(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_grad_clip():
    cfg = adamw.AdamWConfig(lr=0.1, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    state = adamw.init(params)
    _, _, gnorm = adamw.update(params, {"w": torch.full((3,), 100.0)},
                               state, cfg)
    assert float(gnorm) > 100           # reported pre-clip norm


# -------------------------- compression -------------------------------- #

def test_int8_error_feedback_matches_jax_bit_for_bit():
    """Twenty rounds of compress and decompress over gradients with
    ties (values that land on x.5 of the scale): the int8 values, the
    scales, the residuals and the decompressed gradients equal the JAX
    package's bit for bit (both round half to even)."""
    rng = np.random.default_rng(3)
    comp, jcomp = ErrorFeedbackInt8(), JInt8()
    g0 = {"a": np.linspace(-5, 5, 1000).astype(np.float32),
          "b": {"c": (rng.integers(-254, 255, (64,)) / 2.0
                      ).astype(np.float32)}}
    st, jst = comp.init(_torch(g0, torch.float32)), jcomp.init(_jax(
        g0, jnp.float32))
    for i in range(20):
        g = {"a": g0["a"] * (1 + i / 7),
             "b": {"c": rng.standard_normal(64).astype(np.float32)}}
        q, st = comp.compress(_torch(g, torch.float32), st)
        jq, jst = jcomp.compress(_jax(g, jnp.float32), jst)
        for got, want in ((q.values, jq.values), (q.scales, jq.scales),
                          (st, jst), (comp.decompress(q),
                                      jcomp.decompress(jq))):
            for a, b in zip(leaves(got), jax.tree.leaves(want),
                            strict=True):
                assert np.array_equal(a.numpy(), np.asarray(b)), i
        assert all(v.dtype == torch.int8 for v in leaves(q.values))


def test_int8_error_feedback_converges():
    comp = ErrorFeedbackInt8()
    w = torch.tensor([2.0, -3.0, 1.5])
    target = torch.tensor([0.5, 0.25, -1.0])
    state = comp.init({"w": w})
    for _ in range(200):
        q, state = comp.compress({"w": 2 * (w - target)}, state)
        w = w - 0.05 * comp.decompress(q)["w"]
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=1e-2)


def test_int8_quantisation_bounded_error():
    comp = ErrorFeedbackInt8()
    g = {"a": torch.linspace(-5, 5, 1000)}
    q, _ = comp.compress(g, comp.init(g))
    back = comp.decompress(q)
    assert float((back["a"] - g["a"]).abs().max()) <= 5 / 127 + 1e-6
    assert ErrorFeedbackInt8.bytes_ratio(torch.bfloat16) == 2.0


def test_randomk_mass_conserving():
    rk = RandomK(fraction=0.25)
    g = {"a": torch.ones(4096)}
    st = rk.init(g, seed=0)
    acc = torch.zeros(4096)
    for i in range(40):
        q, st = rk.compress(g, st)
        acc = acc + q["a"]
        total = acc + st["residual"]["a"]
        np.testing.assert_allclose(total.numpy(), (i + 1) * np.ones(4096),
                                   atol=1e-4)
    assert abs(float(acc.mean()) / 40 - 1.0) < 0.15


def test_randomk_converges_quadratic():
    rk = RandomK(fraction=0.3)
    w = torch.tensor([2.0, -3.0, 1.5, 0.7])
    target = torch.tensor([0.5, 0.25, -1.0, 0.0])
    st = rk.init({"w": w}, seed=1)
    for _ in range(400):
        q, st = rk.compress({"w": 2 * (w - target)}, st)
        w = w - 0.05 * q["w"]
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=5e-2)


def test_randomk_masks_follow_the_seed():
    g = {"a": torch.ones(256), "b": {"c": torch.ones(64)}}
    runs = []
    for seed in (5, 5, 6):
        rk = RandomK(fraction=0.5)
        q, _ = rk.compress(g, rk.init(g, seed=seed))
        runs.append(torch.cat([t for t in leaves(q)]))
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert 0.35 < float((runs[0] != 0).float().mean()) < 0.65


# ------------------------------ data ---------------------------------- #

@pytest.mark.parametrize("shards", [1, 2])
def test_pipeline_batches_equal_the_references(shards):
    """Several steps, then a restore, each shard: the same tokens and
    labels as the JAX package's pipeline."""
    for shard in range(shards):
        cfg = dict(global_batch=4, seq_len=48, data_shards=shards)
        p = Pipeline(SyntheticLM(vocab=500, seed=4), DataConfig(**cfg),
                     shard=shard)
        jp = JPipeline(JSyntheticLM(vocab=500, seed=4), JDataConfig(**cfg),
                       shard=shard)
        for _ in range(3):
            a, b = p.next(), jp.next()
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
        p.restore({"step": 1, "shard": shard})
        jp.restore({"step": 1, "shard": shard})
        assert np.array_equal(p.next()["tokens"], jp.next()["tokens"])
        assert p.state() == jp.state()


def test_pipeline_deterministic_across_restarts():
    src = SyntheticLM(vocab=1000, seed=7)
    cfg = DataConfig(global_batch=8, seq_len=64, data_shards=2)
    p1 = Pipeline(src, cfg, shard=0)
    batches = [p1.next() for _ in range(3)]
    p2 = Pipeline(src, cfg, shard=0)
    p2.restore({"step": 2, "shard": 0})
    np.testing.assert_array_equal(p2.next()["tokens"], batches[2]["tokens"])


def test_pipeline_shards_disjoint():
    src = SyntheticLM(vocab=1000)
    cfg = DataConfig(global_batch=8, seq_len=32, data_shards=4)
    rows = [Pipeline(src, cfg, shard=s).next()["tokens"] for s in range(4)]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.array_equal(rows[i], rows[j])


def test_pipeline_elastic_rescale_exactly_once():
    src = SyntheticLM(vocab=100, seed=3)
    cfg2 = DataConfig(global_batch=8, seq_len=16, data_shards=2)
    a = Pipeline(src, cfg2, shard=0)
    a.restore({"step": 5, "shard": 0}, new_shard=0, new_nshards=2)
    b = Pipeline(src, cfg2, shard=0, start_step=5)
    np.testing.assert_array_equal(a.next()["tokens"], b.next()["tokens"])


def test_labels_are_shifted_tokens():
    p = Pipeline(SyntheticLM(vocab=50), DataConfig(global_batch=2,
                                                   seq_len=16))
    b = p.next()
    assert b["tokens"].shape == b["labels"].shape == (2, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
