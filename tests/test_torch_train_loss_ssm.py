"""Training's loss and its gradients in the port against
``jax.value_and_grad`` of the JAX package's ``ModelApi.loss_fn``, on the
CPU, for Mamba2's SSM, Zamba2's hybrid and Whisper's encoder-decoder at
their reduced configs, in float32 and bfloat16, with the JAX package's
weights carried across; remat on against off, bit for bit; the SSD
families' training backbone, which pads without masking ``dt`` as the
JAX package's does (not the serving prefill's masked scan); Whisper's
bfloat16 position table.  Tolerances: ``_torch_train.py``.  The
transformer family is in ``test_torch_train_loss.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from _torch_train import (GRAD_TOL, LOSS_TOL, batch_np, both,
                          jax_loss_and_grads, port_loss_and_grads, rel_fro,
                          torch_batch)
from repro.models import encdec as jencdec
from repro.models import hybrid as jhybrid
from repro.models import mamba_lm as jmamba
from repro_torch.models import encdec, hybrid, mamba_lm, registry
from repro_torch.models.common import leaves

IDS = ("mamba2-2.7b", "zamba2-2.7b", "whisper-medium")
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [5, 8, 13])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_the_training_backbone_pads_as_the_jax_package_does(arch, dtype, t):
    """The hidden states of the SSD families' training backbone against
    the JAX package's at token counts below, at and past the reduced
    chunk (8): the tokens padded with zeros and ``dt`` not masked, the
    states cut back to T."""
    japi, jparams, api, params = both(arch, dtype)
    toks = np.random.default_rng(t).integers(0, api.cfg.vocab, size=(2, t))
    jmod, mod = (jmamba, mamba_lm) if arch == "mamba2-2.7b" \
        else (jhybrid, hybrid)
    want = jmod.backbone(jparams, jnp.asarray(toks), japi.cfg, None)
    got = mod.backbone(params, torch.from_numpy(toks), api.cfg)
    assert tuple(got.shape) == want.shape == (2, t, api.cfg.d_model)
    assert rel_fro(got.float().numpy(), np.asarray(want, np.float32)) <= \
        (1e-5 if dtype == "float32" else 1e-2)


def test_segments_cut_the_stacked_mamba_layers():
    api = registry.get_reduced("zamba2-2.7b")
    params = api.init_params(0, device="cpu")
    segs = hybrid._segments(params["mamba"], api.cfg)
    per = api.cfg.attn_every
    assert len(segs) == api.cfg.n_layers // per
    for i, seg in enumerate(segs):
        for got, whole in zip(leaves(seg), leaves(params["mamba"])):
            assert torch.equal(got, whole[i * per:(i + 1) * per])


def test_whisper_decode_train_adds_the_bfloat16_position_table():
    """In float32 too, the decoder adds the position table rounded to
    bfloat16, as the JAX package does: the teacher-forced hidden states
    equal the JAX package's within float32's sums."""
    japi, jparams, api, params = both("whisper-medium", "float32")
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((2, 9, api.cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, api.cfg.vocab, size=(2, api.cfg.dec_seq))
    jenc = jencdec.encode(jparams, jnp.asarray(frames), japi.cfg, None)
    want = jencdec.decode_train(jparams, jenc, jnp.asarray(toks), japi.cfg,
                                None)
    enc = encdec.encode(params, torch.from_numpy(frames), api.cfg,
                        remat=True)
    got = encdec.decode_train(params, enc, torch.from_numpy(toks), api.cfg,
                              remat=True)
    assert rel_fro(enc.numpy(), np.asarray(jenc)) <= 1e-5
    assert rel_fro(got.numpy(), np.asarray(want)) <= 1e-5
