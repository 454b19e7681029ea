"""PyTorch port, the duration-predictor curriculum (`training/trainer.py`) and
the CLI's drive loop (`training/cli.py` ``_run_training``), against the JAX
package on the same weights, batches and random draws (the loss's draws taken
with `jax.random` in the JAX order, as `tests/test_torch_training.py` does).
The trainer's optimizer options and gradient accumulation with the
curriculum are held in `tests/test_torch_training_options.py`.

Tiny DiT as `tests/test_torch_training.py` (dim 32, one block, fp32) and a
duration predictor (d_model 16, filter 16). Limits as there: losses and
gradients 1e-4 of scale, parameters after the updates 1e-5. In the focus
phase the backbone and its EMA are held bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.models.duration import DurationPredictor as JDurationPredictor
from eraxvif5tts_tpu.models.duration import load_duration_predictor as j_load_duration
from eraxvif5tts_tpu.models.duration import predict_duration_frames as j_predict_frames
from eraxvif5tts_tpu.models.duration import save_duration_predictor as j_save_duration
from eraxvif5tts_tpu.training import alignment as jal
from eraxvif5tts_tpu.training import trainer as jtr
from eraxvif5tts_tpu_torch.configs import (
    ArchConfig,
    CkptConfig,
    DatasetConfig,
    MelSpecConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from eraxvif5tts_tpu_torch.models.duration import (
    DurationPredictor,
    duration_state_dict_from_jax,
    load_duration_predictor,
    predict_duration_frames,
)
from eraxvif5tts_tpu_torch.training import cli
from eraxvif5tts_tpu_torch.training import trainer as ttr
from eraxvif5tts_tpu_torch.training.dataset import CustomDataset
from test_torch_training import MEL, _batch, _jax_draws, _jax_params, _port_cfm, _torch_grads
from test_torch_models import close

PRED_VOCAB = 12
SPEC = dict(learning_rate=1e-3, num_warmup_updates=1, total_updates=10, max_grad_norm=1e6)


def _phoneme_batch(seed, b=2, n=16):
    batch = _batch(seed=seed, b=b, n=n, lens=[16, 13])
    rng = np.random.default_rng(seed)
    ph = np.zeros((b, 6), np.int32)
    for i, count in enumerate((6, 4)):  # no phoneme follows itself
        ph[i, :count] = rng.permutation(np.arange(1, PRED_VOCAB))[:count]
    batch["phoneme"] = ph
    return batch


def _trainers(focus_updates, seed=1, accumulate=1):
    """The JAX and the port trainers with a duration predictor on the same weights."""
    jcfm, params = _jax_params(seed=seed)
    jdp = JDurationPredictor(vocab_size=PRED_VOCAB, d_model=16, d_filter=16)
    ids = jnp.zeros((1, 8), jnp.int32)
    rng = np.random.default_rng(seed)
    dparams = jax.tree.map(lambda p: (0.2 * rng.standard_normal(p.shape)).astype(np.float32),
                           jax.jit(jdp.init)(jax.random.key(0), ids, ids > 0)["params"])
    common = dict(ema_update_after_step=0, ema_update_every=1,
                  duration_focus_updates=focus_updates, duration_lr=1e-3,
                  grad_accumulation_steps=accumulate)
    jt = jtr.Trainer(cfm=jcfm, optimizer=jtr.make_optimizer(**SPEC), duration_predictor=jdp,
                     **common)
    jstate = jt.init_state(jax.random.key(0), params=params, dur_pred_params=dparams)
    dp = DurationPredictor(PRED_VOCAB, 16, 16)
    dp.load_state_dict(duration_state_dict_from_jax(dparams))
    trainer = ttr.Trainer(cfm=_port_cfm(params), optimizer=ttr.make_optimizer(**SPEC),
                          duration_predictor=dp, **common)
    return jt, jstate, trainer, trainer.init_state(), (jcfm, params, jdp, dparams)


def _captured_grads(state):
    """Record the gradients each optimizer step is given (the main one after
    clipping, which SPEC's norm limit makes a no-op)."""
    seen = {}
    for name, opt, module in (("main", state.optimizer, state.model),
                              ("dur", state.dur_optimizer, state.dur_predictor)):
        step = opt.step

        def wrapped(*a, _step=step, _name=name, _module=module, **k):
            seen[_name] = {n: p.grad.clone() for n, p in _module.named_parameters()}
            return _step(*a, **k)

        opt.step = wrapped
    return seen


def _jax_grads(models, batch, rng, weight, focus):
    """The JAX curriculum loss's gradients: (backbone, predictor) in the full
    phase, the predictor's alone in the focus phase."""
    jcfm, params, jdp, dparams = models
    table = dparams["embed"]["embedding"]
    proj = jnp.asarray(jal.make_mel_proj_matrix(MEL, table.shape[1]))

    def d_loss(dp):
        return jal.duration_loss(jdp, dp, table, proj, batch["phoneme"], batch["mel"],
                                 batch["lens"], "window")[0]

    if focus:
        return None, jax.jit(jax.grad(d_loss))(dparams)
    return jax.jit(jax.grad(
        lambda p, dp: jcfm.loss(p, batch["mel"], batch["text"], batch["lens"], rng)[0]
        + weight * d_loss(dp), argnums=(0, 1)))(params, dparams)


def _close_tree(got: dict, want: dict, rel, what):
    assert set(got) == set(want), what
    for name, w in want.items():
        g = got[name]
        close(g.detach().float().numpy() if torch.is_tensor(g) else g, w, rel, f"{what} {name}")


@pytest.mark.parametrize("phase", ["focus", "full"])
def test_curriculum_update_matches_jax(phase):
    focus = phase == "focus"
    jt, jstate, trainer, state, models = _trainers(focus_updates=5 if focus else 0)
    params0 = {k: v.detach().clone() for k, v in state.params.items()}
    for i in range(2):
        batch, rng = _phoneme_batch(10 + i), jax.random.key(20 + i)
        if i == 0:
            seen = _captured_grads(state)
            jmain, jdur = _jax_grads(models, batch, rng, 0.5, focus)
        jstate, jm = jt.train_step(jstate, batch, rng)
        state, m = trainer.train_step(state, batch, _jax_draws(rng, 2, 16))
        for key in ("loss", "cfm_loss", "duration_loss", "duration_mae", "align_coverage",
                    "align_diagonal", "duration_weight", "grad_norm", "applied"):
            close(m[key], float(jm[key]), 1e-4, f"{phase} {i} {key}")
        np.testing.assert_array_equal(  # the JAX trainer pads the batch to its mesh
            m["align_durations"].numpy(), np.asarray(jm["align_durations"])[:2])
        if i == 0:  # the gradients each optimizer was handed
            _close_tree(seen["dur"], duration_state_dict_from_jax(jdur), 1e-4, "dur grad")
            if focus:
                assert "main" not in seen
            else:
                _close_tree(seen["main"], _torch_grads(jmain), 1e-4, "grad")
    assert state.step == int(jstate.step) == 2
    assert trainer.alignment_manager.phase == jt.alignment_manager.phase == (1 if focus else 2)
    _close_tree(dict(state.dur_predictor.named_parameters()),
                duration_state_dict_from_jax(jstate.dur_pred_params), 1e-5, "dur param")
    _close_tree(state.dur_align.state_dict(),
                duration_state_dict_from_jax(jstate.dur_align_params), 0, "align (frozen)")
    if focus:  # the backbone and its EMA stay bit for bit
        for k, v in state.params.items():
            assert torch.equal(v, params0[k]), k
            assert torch.equal(state.ema_params[k], params0[k]), k
    _close_tree(state.params, _torch_grads(jstate.params), 1e-5, "param")
    _close_tree(state.ema_params, _torch_grads(jstate.ema_params), 1e-5, "ema")
    assert trainer._make_meta(0, 2) == jt._make_meta(0, 2)


def test_meta_round_trip_restores_the_phoneme_map_in_place():
    dp = DurationPredictor(PRED_VOCAB, 16, 16)
    pm = {"a": 1, "ch": 2}
    trainer = ttr.Trainer(cfm=_port_cfm(), optimizer=ttr.make_optimizer(), duration_predictor=dp,
                          phoneme_map=pm, use_adaptive_duration_weight=True)
    trainer.train(trainer.init_state(), batches=[], epochs=3)  # arms the weight schedule
    trainer.alignment_manager.phase, trainer.alignment_manager.current_method = 2, "viterbi"
    trainer._phase2_start = 7
    trainer._dur_weight_sched.ema_cov, trainer._dur_weight_sched.prev_weight = 0.25, 0.4
    meta = trainer._make_meta(2, 5)
    assert meta["phoneme_map"] == pm and meta["alignment"] == {
        "phase": 2, "method": "viterbi", "phase2_start": 7}

    live = {"z": 9}  # the dict the collate closure of a resumed run holds
    resumed = ttr.Trainer(cfm=_port_cfm(), optimizer=ttr.make_optimizer(),
                          duration_predictor=DurationPredictor(PRED_VOCAB, 16, 16),
                          phoneme_map=live, use_adaptive_duration_weight=True)
    resumed.train(resumed.init_state(), batches=[], epochs=3)
    assert resumed.restore_meta(meta) == (2, 5)
    assert resumed.phoneme_map is live and live == pm
    assert resumed.alignment_manager.phase == 2 and resumed._phase2_start == 7
    assert resumed.alignment_manager.current_method == "viterbi"
    s = resumed._dur_weight_sched
    assert (s.ema_cov, s.prev_weight, s.phase) == (0.25, 0.4, trainer._dur_weight_sched.phase)
    assert resumed._make_meta(2, 5) == meta


# ---------------------------------------------------------------------------
# the CLI's drive loop (counterpart of `tests/test_cli_training.py:70`)

VOCAB = {c: i for i, c in enumerate(" abcdefgh")}


def _tiny_cfg(tmp_path, **ckpt_kw):
    return TrainConfig(
        model=ModelConfig(
            name="tiny", tokenizer="char",
            arch=ArchConfig(dim=32, depth=1, heads=2, dim_head=16, ff_mult=2,
                            text_dim=16, conv_layers=0, dropout=0.0),
            mel_spec=MelSpecConfig(n_mel_channels=MEL)),
        optim=OptimConfig(epochs=1, learning_rate=1e-4, num_warmup_updates=1),
        datasets=DatasetConfig(name="tiny", batch_size_per_gpu=64, max_samples=2,
                               num_workers=2),
        ckpts=CkptConfig(save_per_updates=2, last_per_updates=0, keep_last_n_checkpoints=-1,
                         logger=None, log_samples=True, save_dir=str(tmp_path / "ckpts"),
                         **ckpt_kw))


def _tiny_dataset(n=4):
    rng = np.random.default_rng(0)
    rows = [{"text": "abc ad"[: 3 + i % 3], "duration": (16 + 4 * i) * 256 / 24000,
             "mel_spec": rng.standard_normal((16 + 4 * i, MEL)).astype(np.float32),
             "phoneme": "a b c"} for i in range(n)]
    return CustomDataset(rows, preprocessed_mel=True)


def test_run_training_duration_curriculum_end_to_end(tmp_path, capsys):
    cfg = _tiny_cfg(tmp_path)
    dataset = _tiny_dataset()
    sampler = cli.build_sampler(dataset, cfg, seed=0)
    phoneme_map: dict = {}
    trainer = cli.build_trainer(cfg, vocab_size=len(VOCAB), total_updates=10,
                                duration_predictor=DurationPredictor(len(VOCAB) + 1, 16, 16),
                                duration_focus_updates=1, phoneme_map=phoneme_map,
                                device="cpu")
    state = cli._run_training(trainer, cfg, dataset, sampler, VOCAB, trainer.init_state(), 0,
                              phoneme_map=phoneme_map, log_every=1)
    out = capsys.readouterr().out
    assert "duration_loss=" in out and "duration_mae=" in out and state.step == 2
    ckpt_dir = tmp_path / "ckpts"
    assert (ckpt_dir / "model_last").is_dir() and (ckpt_dir / "model_2").is_dir()
    samples = sorted(os.listdir(ckpt_dir / "samples"))
    assert samples == ["update_2_0.gl.wav", "update_2_0.npy"]
    assert np.isfinite(np.load(ckpt_dir / "samples" / "update_2_0.npy")).all()
    assert (ckpt_dir / "duration_predictor_2.pt").is_file()

    # the predictor file loads in both packages, and a JAX-written one in the port
    path = str(ckpt_dir / "duration_predictor_last.pt")
    model, loaded_map = load_duration_predictor(path, "cpu")
    assert loaded_map == phoneme_map and len(loaded_map) >= 3
    jmodel, jparams, jmap = j_load_duration(path)
    assert jmap == phoneme_map
    for text in ("abc", "cab ba"):
        assert predict_duration_frames(model, loaded_map, text) == j_predict_frames(
            jmodel, jparams, jmap, text) >= 0
    jpath = str(tmp_path / "from_jax.pt")
    j_save_duration(jpath, jparams, jmap, update=5)
    model2, map2 = load_duration_predictor(jpath, "cpu")
    assert map2 == jmap
    for k, v in model2.state_dict().items():  # the filler row 0 is no id's: JAX writes zeros
        np.testing.assert_array_equal(v.numpy()[k == "text_embed.weight":],
                                      model.state_dict()[k].numpy()[k == "text_embed.weight":],
                                      err_msg=k)
    assert predict_duration_frames(model2, map2, "cab") == predict_duration_frames(
        model, loaded_map, "cab")

    # resume from model_2 with its sidecar: the map restored in place, nothing left to run
    live: dict = {}
    resumed = cli.build_trainer(cfg, vocab_size=len(VOCAB), total_updates=10,
                                duration_predictor=DurationPredictor(len(VOCAB) + 1, 16, 16),
                                duration_focus_updates=1, phoneme_map=live, device="cpu")
    again = cli._run_training(resumed, cfg, dataset, sampler, VOCAB, resumed.init_state(), 0,
                              phoneme_map=live, resume=str(ckpt_dir / "model_2"))
    assert again.step == 2 and live == phoneme_map
    assert resumed.alignment_manager.phase == trainer.alignment_manager.phase == 2
    for k, v in again.params.items():
        assert torch.equal(v, state.params[k]), k


def test_unported_options_are_refused(tmp_path, monkeypatch):
    """The refused options raise; the multi-device ones (item E: ZeRO-1,
    ``--n-model``, ``--multihost``, ``multihost_epoch_batches``) now build a
    mesh trainer, here in a process group of one, and raise only where the
    JAX package does: a mesh that does not cover the processes, a multi-host
    start with no cluster to join."""
    import torch.distributed as dist

    from eraxvif5tts_tpu_torch.training.dataset import TRAIN_FRAME_BUCKETS, TRAIN_TEXT_BUCKETS

    cfg = _tiny_cfg(tmp_path)
    for optim, match in ((dict(bnb_optimizer=True), "bnb_optimizer"),
                         (dict(mu_dtype="float16"), "mu_dtype")):
        bad = TrainConfig(model=cfg.model, optim=OptimConfig(**optim), datasets=cfg.datasets,
                          ckpts=cfg.ckpts)
        with pytest.raises(ValueError, match=match):
            cli.build_trainer(bad, len(VOCAB), 10, device="cpu")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    (tmp_path / "c.yaml").write_text("model:\n  name: tiny\n", encoding="utf-8")
    with pytest.raises(ValueError, match="torchrun"):
        cli.train_main([str(tmp_path / "c.yaml"), "--multihost", "--device", "cpu"])
    with pytest.raises(ValueError, match="torchrun"):
        cli.finetune_main(["--dataset_name", "x", "--multihost", "--device", "cpu"])
    with pytest.raises(SystemExit):  # the compile-time mode is left out
        cli.train_main([str(tmp_path / "c.yaml"), "--scan-layers"])

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'group'}", rank=0,
                            world_size=1)
    try:
        zero1 = TrainConfig(model=cfg.model, optim=OptimConfig(zero1=True),
                            datasets=cfg.datasets, ckpts=cfg.ckpts)
        trainer = cli.build_trainer(zero1, len(VOCAB), 10, device="cpu")
        assert trainer.zero1 and trainer.mesh.mesh_dim_names == ("data", "model")
        assert tuple(trainer.mesh.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="not divisible by model=2"):
            cli.build_trainer(cfg, len(VOCAB), 10, n_model=2, device="cpu")
        dataset = _tiny_dataset()
        sampler = cli.build_sampler(dataset, cfg, seed=0)
        batches = list(cli.multihost_epoch_batches(dataset, sampler, VOCAB, 0, trainer.mesh))
        assert len(batches) == len(sampler)
        assert {b["mel"].shape[1:] for b in batches} == {(TRAIN_FRAME_BUCKETS[-1], MEL)}
        assert {b["text"].shape[1] for b in batches} == {TRAIN_TEXT_BUCKETS[-1]}
        with pytest.raises(ValueError, match="not divisible by model=2"):
            cli.train_main([str(tmp_path / "c.yaml"), "--n-model", "2", "--device", "cpu"])
        # --zero1 and --multihost reach the drive loop with a mesh trainer
        monkeypatch.setattr(cli, "get_tokenizer", lambda *a, **k: (VOCAB, len(VOCAB)))
        monkeypatch.setattr(cli, "load_dataset", lambda *a, **k: dataset)
        monkeypatch.setitem(cli.PRESETS, "F5TTS_v1_Base", cfg.model)
        monkeypatch.setattr(cli, "_run_training", lambda trainer, *a, **k: (trainer, k))
        trainer, kw = cli.finetune_main(["--dataset_name", "x", "--zero1", "--multihost",
                                         "--device", "cpu"])
        assert trainer.zero1 and trainer.mesh is not None and kw["multihost"]
    finally:
        dist.destroy_process_group()


def test_loggers_fall_through_wandb_tensorboard_off(monkeypatch, capsys, tmp_path):
    """``logger="wandb"`` without wandb falls back to tensorboard, and without
    tensorboard logging goes off, each with a printed line (the JAX
    trainer's ``_open_loggers``); a stand-in writer gets every scalar."""
    import sys

    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trainer = ttr.Trainer(cfm=_port_cfm(), optimizer=ttr.make_optimizer())
    assert trainer._open_loggers("wandb", None) == (None, None)
    out = capsys.readouterr().out
    assert "falling back to tensorboard" in out and "scalar logging off" in out

    seen = []

    class Writer:
        def __init__(self, log_dir):
            seen.append(log_dir)

        def add_scalar(self, name, value, step):
            seen.append((name, step))

        def close(self):
            seen.append("closed")

    fake = type(sys)("torch.utils.tensorboard")
    fake.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    trainer.train(trainer.init_state(), batches=[_batch(seed=1)], log_every=1,
                  logger="tensorboard", tensorboard_dir=str(tmp_path / "runs"))
    assert seen[0] == str(tmp_path / "runs") and ("loss", 1) in seen and seen[-1] == "closed"
