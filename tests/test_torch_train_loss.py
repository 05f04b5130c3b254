"""Training's loss and its gradients in the port against
``jax.value_and_grad`` of the JAX package's ``ModelApi.loss_fn``, on the
CPU, for the transformer family's seven ids at their reduced configs
(dense GQA, Chameleon, DBRX's MoE, DeepSeek-V2's MLA + MoE), in float32
and bfloat16, with the JAX package's weights carried across; remat on
against off, bit for bit; the loss's parts (``unembed``,
``cross_entropy``, ``chunked_loss``), ``moe_ffn``'s gradients and the
MoE's auxiliary loss.  Tolerances: ``_torch_train.py``.  The SSD and
encoder-decoder families are in ``test_torch_train_loss_ssm.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from _torch_train import (GRAD_TOL, LOSS_TOL, batch_np, both,
                          jax_loss_and_grads, port_loss_and_grads, rel_fro,
                          torch_batch)
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch.launch import steps
from repro_torch.models import layers, moe, transformer
from repro_torch.models.common import leaves

IDS = ("tinyllama-1.1b", "qwen2-7b", "qwen2.5-14b", "qwen2.5-32b",
       "chameleon-34b", "dbrx-132b", "deepseek-v2-236b")
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module")
def parity():
    """(id, dtype) -> (JAX loss and gradients, the port's), each computed
    once for the module."""
    done = {}

    def get(arch, dtype):
        if (arch, dtype) not in done:
            japi, jparams, api, params = both(arch, dtype)
            batch = batch_np(api.cfg)
            done[arch, dtype] = (
                jax_loss_and_grads(japi, jparams, batch, dtype),
                port_loss_and_grads(api, params, batch, dtype))
        return done[arch, dtype]

    return get


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", IDS)
def test_loss_matches_jax(parity, arch, dtype):
    (jloss, _), (loss, _) = parity(arch, dtype)
    assert np.isfinite(loss) and loss > 0
    assert abs(loss - jloss) / abs(jloss) <= LOSS_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", IDS)
def test_gradients_match_jax(parity, arch, dtype):
    """Every gradient leaf within ``GRAD_TOL`` of its Frobenius norm; in
    bfloat16 within the larger of that and twice the JAX package's own
    bfloat16 distance from its float32 gradient of the same weights (two
    bfloat16 evaluations each as near the float32 one can differ by that
    much: a router or a normaliser's gradient sums many rounded terms,
    and DBRX's and DeepSeek-V2's MoE and MLA leaves sit 5-20 % from
    float32 in the JAX package itself)."""
    (_, jgrads), (_, grads) = parity(arch, dtype)
    floors = [0.0] * len(jgrads)
    if dtype == "bfloat16":
        floors = [rel_fro(want, want32) for want, want32 in
                  zip(jgrads, parity(arch, "float32")[0][1], strict=True)]
    assert len(grads) == len(jgrads)
    for got, want, floor in zip(grads, jgrads, floors, strict=True):
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        assert rel_fro(got, want) <= max(GRAD_TOL[dtype], 2 * floor)


@pytest.mark.parametrize("arch", IDS)
def test_remat_leaves_loss_and_gradients_bit_for_bit(arch):
    """The two-level checkpointing recomputes the same operations on the
    same inputs: loss and every gradient equal to the run that keeps
    every activation, in bfloat16 (the dtype that training runs in)."""
    api = both(arch, "bfloat16")[2]
    params = api.init_params(3, device="cpu")
    batch = torch_batch(batch_np(api.cfg, seed=6), "bfloat16")
    runs = []
    for remat in (True, False):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss = api.loss_fn(params, batch, remat=remat)
        runs.append((loss.detach(), torch.autograd.grad(loss, flat)))
        for p in flat:
            p.requires_grad_(False)
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2, strict=True))


@pytest.mark.parametrize("n,want", [(1, 1), (2, 1), (4, 2), (6, 2), (9, 3),
                                    (12, 3), (22, 2), (28, 4), (40, 5),
                                    (60, 6)])
def test_best_group_is_the_references(n, want):
    assert transformer._best_group(n) == jtransformer._best_group(n) == want


def test_two_level_scan_runs_every_layer_once_forward():
    """Each of the layers runs once, in order, whatever the grouping."""
    for n in (1, 6, 7, 22):
        seen = []

        def layer(x, lp):
            seen.append(int(lp))
            return x + lp

        stacked = torch.arange(n, dtype=torch.float32)
        out = transformer.two_level_scan(layer, torch.zeros(()), stacked, n)
        assert seen == list(range(n)) and float(out) == n * (n - 1) / 2


def test_unembed_and_cross_entropy_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 5)).astype(np.int32)
    labels[1, 2:] = -1
    got = layers.unembed(torch.from_numpy(x), torch.from_numpy(table))
    want = jlayers.unembed(jnp.asarray(x), jnp.asarray(table))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ce = layers.cross_entropy(got, torch.from_numpy(labels))
    jce = jlayers.cross_entropy(want, jnp.asarray(labels))
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-6)
    # no valid label: the count is clamped at 1, the loss 0
    none = torch.full((2, 5), -1)
    assert float(layers.cross_entropy(got, none)) == 0.0


@pytest.mark.parametrize("s,chunk", [(13, 4), (16, 8), (5, 512)])
def test_chunked_loss_matches_jax(s, chunk):
    """Chunks that do not divide the sequence (the last padded with -1
    labels), that divide it, and one chunk longer than it; values and
    the gradients of the hidden states and the head."""
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32) * 0.25
    lab = rng.integers(-1, 40, size=(2, s)).astype(np.int32)
    jl, (jgh, jghead) = jax.value_and_grad(
        lambda hh, ww: jtransformer.chunked_loss(hh, ww, jnp.asarray(lab),
                                                 chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_(True)
    thead = torch.from_numpy(head).requires_grad_(True)
    loss = transformer.chunked_loss(th, thead, torch.from_numpy(lab),
                                    chunk=chunk)
    gh, ghead = torch.autograd.grad(loss, (th, thead))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(gh.numpy(), jgh, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ghead.numpy(), jghead, rtol=1e-5, atol=1e-6)


def test_chunked_loss_keeps_one_chunks_logits_for_the_backward():
    """Autograd keeps each chunk's inputs, not its (B, c, V) logits: the
    tensors saved for the backward pass hold no (B, c, V) float32 one."""
    h = torch.randn(2, 32, 8, requires_grad=True)
    head = torch.randn(8, 50, requires_grad=True)
    lab = torch.randint(0, 50, (2, 32))
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = transformer.chunked_loss(h, head, lab, chunk=8)
    assert (2, 8, 50) not in shapes
    loss.backward()
    assert h.grad is not None and torch.isfinite(h.grad).all()


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
def test_moe_ffn_gradients_match_jax(arch):
    """The MoE feed-forward is differentiable through its gathers: its
    output and the gradients of its input and every weight (router,
    experts, shared experts) against JAX's, in float32."""
    japi, jparams, api, params = both(arch, "float32")
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["ffn"])
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in params["layers"]["ffn"].items()}
    x = np.random.default_rng(8).standard_normal(
        (2, 6, api.cfg.d_model)).astype(np.float32)
    w = np.random.default_rng(9).standard_normal(
        (2, 6, api.cfg.d_model)).astype(np.float32)

    def jf(xx, pp):
        return jnp.sum(jmoe.moe_ffn(xx, pp, japi.cfg, None) * w)

    jv, (jgx, jgp) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                                            jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    flat = leaves(p)
    for t in flat:
        t.requires_grad_(True)
    v = (moe.moe_ffn(tx, p, api.cfg) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(v, [tx] + flat)
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    assert rel_fro(grads[0].numpy(), np.asarray(jgx)) <= 1e-5
    for got, want in zip(grads[1:], jax.tree.leaves(jgp), strict=True):
        assert rel_fro(got.numpy(), np.asarray(want)) <= 1e-5


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((3, 7, 4)).astype(np.float32)
    top_e = np.argsort(-logits, axis=-1)[..., :2]
    got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(top_e), 4)
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits),
                                      jnp.asarray(top_e), 4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # balanced routing gives 1
    flat = np.zeros((4, 4), np.float32)
    top = np.arange(4)[:, None]
    assert float(moe.aux_load_balance_loss(
        torch.from_numpy(flat), torch.from_numpy(top), 4)) == \
        pytest.approx(1.0)


def test_value_and_grad_leaves_the_parameters_without_gradients():
    api = both("tinyllama-1.1b", "float32")[2]
    params = api.init_params(0, device="cpu")
    batch = torch_batch(batch_np(api.cfg), "bfloat16")
    loss, grads = steps.value_and_grad(api, params, batch)
    assert not loss.requires_grad
    assert all(not p.requires_grad and p.grad is None
               for p in leaves(params))
    assert [g.shape for g in grads] == [p.shape for p in leaves(params)]
    assert all(g.dtype == p.dtype for g, p in zip(grads, leaves(params)))
