"""PyTorch port, training: `CFM.loss` and its gradients, `Trainer.train_step`
(optimizer, schedule, EMA, accumulation, NaN skip), checkpoints and resume,
against the JAX package on the same weights, batches and random draws (the
draws are taken with `jax.random` in the JAX loss's order and handed to the
port), and the JAX trainer tests' behaviours mirrored on the port.

Tiny model as `tests/test_trainer_resume.py` (dim 32, one block), fp32.
Tolerances, relative to each tensor's scale: loss and gradients 1e-4 (the
backward sums in other orders), parameters and EMA after three steps 1e-5;
the LR schedule 1e-6 (optax computes it in fp32); the port against itself
exact where the arithmetic is the same, and 1e-5 for the accumulated update
against the mean-gradient one (a running mean against a sum, then AdamW's
normalisation; the JAX test's own bound).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eraxvif5tts_tpu.compression.convert import backbone_params_to_torch
from eraxvif5tts_tpu.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu.ops.masks import mask_from_frac_lengths as j_mask_from_frac_lengths
from eraxvif5tts_tpu.training import trainer as jtr
from eraxvif5tts_tpu_torch.compression.convert import state_dict_from_jax
from eraxvif5tts_tpu_torch.models.cfm import CFM, LossDraws
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.ops.masks import mask_from_frac_lengths
from eraxvif5tts_tpu_torch.training import trainer as ttr
from test_torch_models import close, redraw

ARCH = ArchConfig(dim=32, depth=1, heads=2, dim_head=16, ff_mult=2, text_dim=16,
                  conv_layers=0, dropout=0.0)
MEL = 8
VOCAB = 8


def _batch(seed=0, b=2, n=16, lens=None):
    rng = np.random.default_rng(seed)
    return {
        "mel": rng.standard_normal((b, n, MEL)).astype(np.float32),
        "text": np.asarray([[1, 2, -1], [3, 1, -1]], np.int32),
        "lens": np.full((b,), n, np.int32) if lens is None else np.asarray(lens, np.int32),
    }


def _jax_params(seed=0):
    jcfm = JCFM(transformer=JDiT(arch=ARCH, text_num_embeds=VOCAB, mel_dim=MEL))
    return jcfm, redraw(jcfm.init_params(jax.random.key(0)), seed, std=0.2)


def _port_cfm(params=None, arch=ARCH, seed=0):
    torch.manual_seed(seed)
    dit = DiT(arch, VOCAB, MEL)
    if params is not None:
        dit.load_state_dict(state_dict_from_jax(params, None, ModelConfig(arch=arch))[0])
    return CFM(dit.train())


def _jax_draws(rng, b, n, lo=0.7, hi=1.0) -> LossDraws:
    """The JAX loss's draws (`cfm.py:105-127`), in its order."""
    k_frac, k_span, k_x0, k_t, k_a, k_c, _ = jax.random.split(rng, 7)

    def t(a):
        return torch.from_numpy(np.array(a))

    return LossDraws(frac=t(jax.random.uniform(k_frac, (b,), minval=lo, maxval=hi)),
                     rand=t(jax.random.uniform(k_span, (b,))),
                     x0=t(jax.random.normal(k_x0, (b, n, MEL), jnp.float32)),
                     time=t(jax.random.uniform(k_t, (b,), dtype=jnp.float32)),
                     drop_audio=t(jax.random.uniform(k_a, ())),
                     drop_cond=t(jax.random.uniform(k_c, ())))


def _torch_grads(jgrads):
    return backbone_params_to_torch(jgrads, "DiT", ARCH.depth, ARCH.conv_layers,
                                    with_prefix=False)


def test_mask_from_frac_lengths_matches_jax():
    lens = np.array([0, 7, 100, 128], np.int32)
    frac = np.array([0.7, 0.95, 0.83, 1.0], np.float32)
    key = jax.random.key(3)
    want = j_mask_from_frac_lengths(jnp.asarray(lens), jnp.asarray(frac), 128, key)
    rand = np.array(jax.random.uniform(key, lens.shape))
    got = mask_from_frac_lengths(torch.from_numpy(lens), torch.from_numpy(frac), 128,
                                 torch.from_numpy(rand))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rng_seed", [1, 5])
def test_cfm_loss_and_gradients_match_jax(rng_seed):
    jcfm, params = _jax_params()
    batch = _batch(seed=2, lens=[16, 11])
    rng = jax.random.key(rng_seed)
    (want_loss, (want_cond, want_pred)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda out: (out[0], out[1:]))(jcfm.loss(p, batch["mel"], batch["text"],
                                                            batch["lens"], rng)),
        has_aux=True))(params)
    cfm = _port_cfm(params)
    loss, cond, pred = cfm.loss(*(torch.from_numpy(batch[k]) for k in ("mel", "text", "lens")),
                                _jax_draws(rng, 2, 16))
    loss.backward()
    close(loss.item(), float(want_loss), 1e-4, "loss")
    close(cond.numpy(), want_cond, 1e-6, "cond")
    close(pred.detach().numpy(), want_pred, 1e-4, "pred")
    want = _torch_grads(jgrads)
    got = dict(cfm.transformer.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        close(got[name].grad.numpy(), g, 1e-4, f"grad {name}")


def test_cfm_loss_bf16_compute_matches_jax():
    """The card's recipe, fp32 parameters and bf16 compute (`proj_out` in
    fp32, as a flax Dense without a dtype): loss and prediction against the
    JAX model with ``compute_dtype=bfloat16``, within bf16 rounding (2e-2 of
    scale, as `tests/test_torch_models.py`'s bf16 DiT)."""
    arch = dataclasses.replace(ARCH, conv_layers=1)
    jcfm = JCFM(transformer=JDiT(arch=arch, text_num_embeds=VOCAB, mel_dim=MEL,
                                 compute_dtype=jnp.bfloat16))
    params = redraw(jcfm.init_params(jax.random.key(0)), 3)
    batch, rng = _batch(seed=6, lens=[16, 12]), jax.random.key(2)
    want_loss, _, want_pred = jax.jit(lambda p: jcfm.loss(p, batch["mel"], batch["text"],
                                                          batch["lens"], rng))(params)
    dit = DiT(arch, VOCAB, MEL, compute_dtype=torch.bfloat16)
    dit.load_state_dict(state_dict_from_jax(params, None, ModelConfig(arch=arch))[0])
    loss, _, pred = CFM(dit.train()).loss(
        *(torch.from_numpy(batch[k]) for k in ("mel", "text", "lens")), _jax_draws(rng, 2, 16))
    assert pred.dtype == torch.float32 and dit.proj_out.weight.dtype == torch.float32
    close(pred.detach().numpy(), want_pred, 2e-2, "pred bf16")
    close(loss.item(), float(want_loss), 2e-2, "loss bf16")


def test_three_train_steps_match_jax_trainer():
    jcfm, params = _jax_params(seed=1)
    spec = dict(learning_rate=1e-3, num_warmup_updates=1, total_updates=10)
    jt = jtr.Trainer(cfm=jcfm, optimizer=jtr.make_optimizer(**spec),
                     ema_update_after_step=0, ema_update_every=1)
    jstate = jt.init_state(jax.random.key(0), params=params)
    trainer = ttr.Trainer(cfm=_port_cfm(params), optimizer=ttr.make_optimizer(**spec),
                          ema_update_after_step=0, ema_update_every=1)
    state = trainer.init_state()
    for i in range(3):
        batch, rng = _batch(seed=10 + i, lens=[16, 13]), jax.random.key(20 + i)
        jstate, jm = jt.train_step(jstate, batch, rng)
        state, m = trainer.train_step(state, batch, _jax_draws(rng, 2, 16))
        close(m["loss"], float(jm["loss"]), 1e-4, f"loss {i}")
        close(m["grad_norm"], float(jm["grad_norm"]), 1e-4, f"grad_norm {i}")
        assert m["applied"] == float(jm["applied"]) == 1.0
    assert state.step == int(jstate.step) == 3
    for name, want in _torch_grads(jstate.params).items():
        close(state.params[name].detach().numpy(), want, 1e-5, f"param {name}")
    for name, want in _torch_grads(jstate.ema_params).items():
        close(state.ema_params[name].numpy(), want, 1e-5, f"ema {name}")


@pytest.mark.parametrize("decay_type", ["linear", "cosine"])
def test_lr_schedule_matches_optax(decay_type):
    warmup, total, lr = 5, 20, 7.5e-5
    spec = ttr.make_optimizer(lr, warmup, total, decay_type=decay_type)
    decay = (optax.linear_schedule(lr, 0.0, total - warmup) if decay_type == "linear"
             else optax.cosine_decay_schedule(lr, total - warmup, alpha=1e-8))
    want = optax.join_schedules([optax.linear_schedule(0.0, lr, warmup), decay], [warmup])
    opt, sched = spec.build([torch.nn.Parameter(torch.zeros(2))])
    for count in range(warmup + 3):
        # the count-th update runs at the schedule's value at count
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(want(count)), rtol=1e-6,
                                   atol=1e-12)
        opt.step()
        sched.step()
    assert ttr.make_optimizer(1.0, 0, 10).lr_at(0) == 1.0


def _manual_update(cfm, spec, grads):
    """One clipped AdamW update of ``cfm``'s parameters with ``grads``, by hand."""
    params = list(cfm.transformer.parameters())
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()
    scale = 1.0 if norm < spec.max_grad_norm else spec.max_grad_norm / norm
    opt, _ = spec.build(params)
    for p, g in zip(params, grads):
        p.grad = g * scale
    opt.step()


def test_grad_accumulation_matches_mean_gradient_update():
    """k = 4 accumulation == one update on the mean of the 4 micro-gradients
    (mirrors `tests/test_trainer_resume.py:55`)."""
    spec = ttr.make_optimizer(total_updates=100, num_warmup_updates=0, learning_rate=1e-3)
    trainer = ttr.Trainer(cfm=_port_cfm(), optimizer=spec, grad_accumulation_steps=4,
                          ema_update_after_step=0, ema_update_every=1)
    state = trainer.init_state()
    params0 = {k: v.detach().clone() for k, v in state.params.items()}
    draws = [LossDraws.sample(torch.Generator().manual_seed(10 + i), 2, 16, MEL, 1)
             for i in range(4)]
    for i in range(4):
        state, m = trainer.train_step(state, _batch(seed=i), draws[i])
        if i < 3:
            assert state.step == 0 and m["applied"] == 0.0
            for k, v in state.params.items():
                assert torch.equal(v, params0[k])
    assert state.step == 1 and m["applied"] == 1.0

    ref = _port_cfm()
    grads = []
    for i in range(4):
        ref.transformer.zero_grad(set_to_none=True)
        b = _batch(seed=i)
        ref.loss(*(torch.from_numpy(b[k]) for k in ("mel", "text", "lens")), draws[i])[0].backward()
        grads.append([p.grad.clone() for p in ref.transformer.parameters()])
    mean = [sum(gs) / 4 for gs in zip(*grads)]
    _manual_update(ref, spec, mean)
    for (name, p), q in zip(ref.transformer.named_parameters(), state.params.values()):
        close(q.detach().numpy(), p.detach().numpy(), 1e-5, name)


def test_nan_batch_is_skipped():
    trainer = ttr.Trainer(cfm=_port_cfm(), optimizer=ttr.make_optimizer(total_updates=100),
                          ema_update_after_step=0, ema_update_every=1)
    state = trainer.init_state()
    params0 = {k: v.detach().clone() for k, v in state.params.items()}
    opt0 = dict(state.optimizer.state)
    bad = _batch(seed=0)
    bad["mel"][0, 0, 0] = np.nan
    state, m = trainer.train_step(state, bad, torch.Generator().manual_seed(1))
    assert state.step == 0 and m["applied"] == 0.0 and not np.isfinite(m["loss"])
    for k, v in state.params.items():
        assert torch.equal(v, params0[k])
    assert dict(state.optimizer.state) == opt0 and state.scheduler.last_epoch == 0
    assert all(torch.isfinite(e).all() for e in state.ema_params.values())
    state, m = trainer.train_step(state, _batch(seed=1), torch.Generator().manual_seed(2))
    assert state.step == 1 and m["applied"] == 1.0


def test_nan_microbatch_skipped_inside_accumulation():
    trainer = ttr.Trainer(cfm=_port_cfm(), optimizer=ttr.make_optimizer(total_updates=100),
                          grad_accumulation_steps=2)
    state = trainer.init_state()
    bad = _batch(seed=0)
    bad["mel"][:] = np.nan
    state, m = trainer.train_step(state, bad, torch.Generator().manual_seed(1))
    assert state.step == 0 and m["applied"] == 0.0 and state.mini_step == 0
    # the NaN micro-batch was not counted: two more good batches are needed
    state, m = trainer.train_step(state, _batch(seed=1), torch.Generator().manual_seed(2))
    assert state.step == 0
    state, m = trainer.train_step(state, _batch(seed=2), torch.Generator().manual_seed(3))
    assert state.step == 1
    assert all(torch.isfinite(p).all() for p in state.params.values())


def _epoch_batches(epoch, n=3):
    return [_batch(seed=100 * epoch + i) for i in range(n)]


def test_interrupt_resume_reproduces_loss_trajectory(tmp_path):
    """Stop after 2 batches of epoch 0, resume from the checkpoint: the
    remaining losses and the final parameters equal the uninterrupted run's
    (mirrors `tests/test_trainer_resume.py:140`)."""
    def new_trainer(ckpt_dir):
        return ttr.Trainer(cfm=_port_cfm(), optimizer=ttr.make_optimizer(total_updates=100),
                           checkpoint_dir=str(ckpt_dir))

    losses_full = {}
    t_full = new_trainer(tmp_path / "full")
    s_full = t_full.train(t_full.init_state(), seed=42, epoch_iter=_epoch_batches, epochs=2,
                          log_every=1, save_per_updates=0,
                          log_fn=lambda s, m: losses_full.__setitem__(s, m["loss"]))

    t_int = new_trainer(tmp_path / "int")
    t_int.train(t_int.init_state(), seed=42,
                epoch_iter=lambda e: itertools.islice(iter(_epoch_batches(e)), 2),
                epochs=1, log_every=1, save_per_updates=2)

    t_res = new_trainer(tmp_path / "int")
    assert ttr.latest_checkpoint(str(tmp_path / "int")).endswith("model_2")
    restored = t_res.load_checkpoint(str(tmp_path / "int" / "model_2"), t_res.init_state())
    assert t_res.resume_meta == {"epoch": 0, "batch_in_epoch": 2,
                                 "grad_accumulation_steps": 1}
    start_epoch, skip = t_res.restore_meta(t_res.resume_meta)
    losses_res = {}
    restored = t_res.train(restored, seed=42, epoch_iter=_epoch_batches, epochs=2,
                           start_epoch=start_epoch, skip_batches=skip, log_every=1,
                           save_per_updates=0,
                           log_fn=lambda s, m: losses_res.__setitem__(s, m["loss"]))
    assert sorted(losses_res) == [3, 4, 5, 6]
    for step, loss in losses_res.items():
        assert losses_full[step] == loss, f"step {step}: {losses_full[step]} != {loss}"
    for k, v in restored.params.items():
        assert torch.equal(v, s_full.params[k]), k
    for k, v in restored.ema_params.items():
        assert torch.equal(v, s_full.ema_params[k]), k
    assert restored.step == s_full.step == 6


def test_checkpoint_rotation_spares_model_last(tmp_path):
    trainer = ttr.Trainer(cfm=_port_cfm(), optimizer=ttr.make_optimizer(),
                          checkpoint_dir=str(tmp_path), keep_last_n_checkpoints=2)
    state = trainer.init_state()
    for step in (1, 2, 3):
        state.step = step
        trainer.save_checkpoint(state, meta={"epoch": 0, "batch_in_epoch": step})
    trainer.save_checkpoint(state, last=True)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "model_2", "model_2.meta.json", "model_3", "model_3.meta.json", "model_last"]
    assert ttr.latest_checkpoint(str(tmp_path)).endswith("model_last")


def test_checkpoint_activations_give_identical_gradients_with_dropout():
    """With dropout 0.1, checkpointed blocks recompute the same position-hash
    masks from the pre-drawn keys: gradients equal the plain run's."""
    arch = dataclasses.replace(ARCH, depth=2, dropout=0.1)
    grads = []
    for remat in (False, True):
        cfm = _port_cfm(arch=dataclasses.replace(arch, checkpoint_activations=remat))
        b = _batch(seed=4)
        draws = LossDraws.sample(torch.Generator().manual_seed(9), 2, 16, MEL, arch.depth)
        cfm.loss(*(torch.from_numpy(b[k]) for k in ("mel", "text", "lens")),
                 draws)[0].backward()
        grads.append({k: p.grad for k, p in cfm.transformer.named_parameters()})
    assert all(g.abs().max() > 0 for g in grads[0].values())
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k


def test_unported_training_options_raise():
    with pytest.raises(ValueError, match="not ported"):
        DiT(dataclasses.replace(ARCH, checkpoint_activations=True, remat_policy="dots"),
            VOCAB, MEL)
    with pytest.raises(NotImplementedError, match="not ported"):
        ttr.Trainer(cfm=_port_cfm(), optimizer=ttr.make_optimizer(), duration_predictor=object())
    cfm = _port_cfm(arch=dataclasses.replace(ARCH, dropout=0.1))
    b = _batch()
    draws = LossDraws.sample(torch.Generator().manual_seed(0), 2, 16, MEL, 1)
    with pytest.raises(ValueError, match="dropout keys"):
        cfm.loss(*(torch.from_numpy(b[k]) for k in ("mel", "text", "lens")),
                 dataclasses.replace(draws, dropout_keys=None))
