"""The port's train step, training launcher and model FLOPs, on the CPU: a few
AdamW steps lower the loss for every id (the JAX package's
``test_train_step_reduces_loss``, there for six ids); microbatches split
by stride and summed in float32, held against one whole-batch step; one
step against the JAX package's ``make_train_step`` on the same weights and
batch; the launcher end to end with a restart that resumes from the last
committed step and runs no step twice; ``model_flops`` equal to the JAX
package's for every id and applicable cell (integer arithmetic: exact)."""
import jax
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from _torch_train import batch_np, both, jax_batch, rel_fro, torch_batch
from repro.launch import steps as jsteps
from repro.launch.model_flops import model_flops as jmodel_flops
from repro.models import registry as jregistry
from repro.models.common import SHAPES as JSHAPES
from repro.optim import adamw as jadamw
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.model_flops import model_flops
from repro_torch.models import registry
from repro_torch.models.common import SHAPES, cell_applicable, leaves
from repro_torch.optim import adamw


def _smoke_batch(cfg, b=2, t=16):
    """The JAX test's batch shapes (tokens are their own labels; Whisper's
    decoder tokens all ones beside bf16 frames), from a seeded numpy
    generator."""
    rng = np.random.default_rng(2)
    if cfg.family == "audio":
        return {"frames": torch.from_numpy(rng.standard_normal(
                    (b, t, cfg.d_model), dtype=np.float32)).bfloat16(),
                "tokens": torch.ones((b, cfg.dec_seq), dtype=torch.int64),
                "labels": torch.ones((b, cfg.dec_seq), dtype=torch.int64)}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(b, t)))
    return {"tokens": toks, "labels": toks}


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_train_step_reduces_loss(arch):
    """A few AdamW steps on a fixed batch must reduce the loss."""
    api = registry.get_reduced(arch)
    params = api.init_params(0, device="cpu")
    state = adamw.init(params)
    step = steps.make_train_step(api, adamw.AdamWConfig(lr=5e-3),
                                 num_microbatches=1)
    batch = _smoke_batch(api.cfg)
    losses = []
    for _ in range(4):
        loss, gnorm, params, state = step(params, state, batch)
        losses.append(float(loss))
        assert np.isfinite(float(gnorm))
    assert not any(np.isnan(x) for x in losses), (arch, losses)
    assert losses[-1] < losses[0], (arch, losses)
    assert int(state["step"]) == 4


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-2.7b"])
def test_microbatched_step_equals_one_whole_batch_step(monkeypatch, arch,
                                                       m):
    """In float32, m microbatches of 8/m rows (row r to microbatch r % m)
    give the loss, the norm and the mean gradients that ``adamw.update``
    takes of one step over the whole batch: every row has as many valid
    labels, so the per-row losses average alike, and only the order of
    the float32 sums differs (1e-5 of each gradient's norm).  The updated
    parameters are not compared: AdamW's first step moves each weight by
    about ``lr`` times the sign of its gradient, and a gradient within
    rounding of 0 can take either sign."""
    api = registry.get_reduced(arch)
    batch = torch_batch(batch_np(api.cfg, seed=12, b=8), "float32")
    batch["labels"] = batch["labels"].clamp_min(0)       # equal counts
    real_update = adamw.update
    runs = []
    for n in (1, m):
        taken = {}

        def spy(params_, grads, state, cfg, taken=taken):
            taken["grads"] = [g.clone() for g in leaves(grads)]
            return real_update(params_, grads, state, cfg)

        monkeypatch.setattr(adamw, "update", spy)
        params = both(arch, "float32")[3]
        loss, gnorm, _, _ = steps.make_train_step(api, num_microbatches=n)(
            params, adamw.init(params), batch)
        runs.append((float(loss), float(gnorm), taken["grads"]))
    (l1, n1, g1), (l2, n2, g2) = runs
    assert l2 == pytest.approx(l1, rel=1e-6)
    assert n2 == pytest.approx(n1, rel=1e-5)
    for a, b in zip(g1, g2, strict=True):
        assert rel_fro(b.numpy(), a.numpy()) <= 1e-5


def test_microbatches_split_by_stride_and_sum_in_float32(monkeypatch):
    """Row r goes to microbatch r % m (m halved until it divides the
    batch: 8 asked of 6 rows gives 2), and the bfloat16 gradients are
    summed in float32: the step's gradients are the float32 mean of the
    microbatches' own."""
    api = registry.get_reduced("tinyllama-1.1b")
    params = api.init_params(1, device="cpu")
    batch = torch_batch(batch_np(api.cfg, seed=13, b=6), "bfloat16")
    seen, taken = [], {}
    real_vg, real_update = steps.value_and_grad, adamw.update

    def spy_vg(api_, params_, micro, axes=None):
        seen.append(micro["tokens"].clone())
        return real_vg(api_, params_, micro, axes)

    def spy_update(params_, grads, state, cfg):
        taken["grads"] = [g.clone() for g in leaves(grads)]
        return real_update(params_, grads, state, cfg)

    monkeypatch.setattr(steps, "value_and_grad", spy_vg)
    monkeypatch.setattr(adamw, "update", spy_update)
    want = [real_vg(api, params, {k: v[j::2] for k, v in batch.items()})[1]
            for j in range(2)]
    steps.make_train_step(api, num_microbatches=8)(
        params, adamw.init(params), batch)
    assert [t.tolist() for t in seen] == [batch["tokens"][j::2].tolist()
                                          for j in range(2)]
    for got, a, b in zip(taken["grads"], *want, strict=True):
        assert got.dtype == torch.float32
        assert torch.equal(got, (a.float() + b.float()) / 2)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b"])
def test_one_train_step_matches_the_jax_packages(arch):
    """One step of the port's ``make_train_step`` against the JAX
    package's (un-meshed, 2 microbatches), float32, same weights and
    batch: the loss, the norm and every updated parameter."""
    japi, jparams, api, params = both(arch, "float32")
    batch = batch_np(api.cfg, seed=14, b=4)
    jstep = jax.jit(jsteps.make_train_step(
        japi, None, jadamw.AdamWConfig(lr=1e-2), num_microbatches=2))
    jloss, jn, jp, _ = jstep(jparams, jadamw.init(jparams),
                             jax_batch(batch, "float32"))
    loss, n, p, _ = steps.make_train_step(
        api, adamw.AdamWConfig(lr=1e-2), num_microbatches=2)(
        params, adamw.init(params), torch_batch(batch, "float32"))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(n) == pytest.approx(float(jn), rel=1e-4)
    for got, want in zip(leaves(p), jax.tree.leaves(jp), strict=True):
        assert rel_fro(got.numpy(), np.asarray(want)) <= 1e-5


# --------------------------- the launcher ------------------------------ #

def test_train_launcher_end_to_end(tmp_path):
    """Full train loop with checkpoint + restart resume."""
    d = str(tmp_path)
    l1 = train_mod.train("tinyllama-1.1b", smoke=True, steps=4, batch=2,
                         seq_len=32, ckpt_dir=d, checkpoint_every=2,
                         log_every=100, device="cpu")
    assert len(l1.losses) == 4 and l1.start_step == 0
    # resume: should start from step 4 and do nothing more
    l2 = train_mod.train("tinyllama-1.1b", smoke=True, steps=4, batch=2,
                         seq_len=32, ckpt_dir=d, checkpoint_every=2,
                         log_every=100, device="cpu")
    assert l2.losses == [] and l2.start_step == 4


def test_a_restart_resumes_exactly_once_and_equals_an_uninterrupted_run(
        tmp_path):
    """4 steps with checkpoints at 2 and 4, a restart to 6: steps 5 and 6
    run once each, from the restored parameters, optimizer state and data
    position, and give an uninterrupted 6-step run's losses and final
    parameters bit for bit (on the CPU every operation is
    deterministic)."""
    kw = dict(smoke=True, batch=2, seq_len=32, checkpoint_every=2,
              log_every=100, device="cpu")
    d = str(tmp_path)
    first = train_mod.train("tinyllama-1.1b", steps=4, ckpt_dir=d, **kw)
    resumed = train_mod.train("tinyllama-1.1b", steps=6, ckpt_dir=d, **kw)
    whole = train_mod.train("tinyllama-1.1b", steps=6, **kw)
    assert resumed.start_step == 4 and len(resumed.losses) == 2
    assert first.losses + resumed.losses == whole.losses
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(resumed.params) + leaves(resumed.opt_state),
        leaves(whole.params) + leaves(whole.opt_state), strict=True))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4",
                                                          "step_6"]


def test_the_train_cli_runs_on_the_cpu(tmp_path, capsys):
    train_mod.main(["--device", "cpu", "--arch", "mamba2-2.7b", "--steps",
                    "2", "--seq-len", "13", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] first loss" in out
    train_mod.main(["--device", "cpu", "--arch", "mamba2-2.7b", "--steps",
                    "2", "--seq-len", "13", "--ckpt-dir", str(tmp_path)])
    assert "nothing to do: restored step 2" in capsys.readouterr().out


def test_the_launcher_trains_an_encoder_decoder_from_stub_frames():
    run = train_mod.train("whisper-medium", steps=2, batch=2, seq_len=12,
                          log_every=100, device="cpu")
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))


def test_the_launcher_does_not_land_on_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.train("tinyllama-1.1b", steps=1)


# ---------------------------- model FLOPs ------------------------------ #

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_model_flops_equal_the_jax_packages(arch):
    """Every applicable cell, the published and the reduced config: the
    same integer arithmetic, so equal exactly."""
    for get, jget in ((registry.get, jregistry.get),
                      (registry.get_reduced, jregistry.get_reduced)):
        api, japi = get(arch), jget(arch)
        for name, cell in SHAPES.items():
            jcell = JSHAPES[name]
            ok = cell_applicable(api.cfg, cell)
            assert ok == jregistry.cell_applicable(japi.cfg, jcell)
            if ok[0]:
                assert model_flops(api, cell) == jmodel_flops(japi, jcell)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_model_flops_sane(arch):
    """MODEL_FLOPS ordering: train > prefill >> decode; all positive."""
    api = registry.get(arch)
    vals = {}
    for name, cell in SHAPES.items():
        if not cell_applicable(api.cfg, cell)[0]:
            continue
        vals[name] = model_flops(api, cell)
        assert vals[name] > 0, (arch, name)
    assert vals["train_4k"] > vals["decode_32k"]
    assert vals["prefill_32k"] > vals["decode_32k"]


def test_model_flops_dense_matches_6nd():
    """tinyllama train: 6·N·D within 2x of the raw parameter count bound."""
    api = registry.get("tinyllama-1.1b")
    n_params = 1.1e9
    tokens = 256 * 4096
    mf = model_flops(api, SHAPES["train_4k"])
    assert 0.8 * 6 * n_params * tokens < mf < 3 * 6 * n_params * tokens


def test_cell_applicability_matrix():
    """long_500k only for the sub-quadratic ids, as the JAX package says."""
    for arch in registry.ARCH_IDS:
        cfg = registry.get(arch).cfg
        ok, why = cell_applicable(cfg, SHAPES["long_500k"])
        assert ok == cfg.supports_long
        assert ok or "SKIP" in why
        assert cell_applicable(cfg, SHAPES["train_4k"]) == (True, "ok")
