"""PyTorch port, the trainer's options against the JAX trainer and optax
(`training/trainer.py`): gradient accumulation with the duration-predictor
curriculum (both optimizers through ``optax.MultiSteps`` in JAX), the main
optimizer's state through the focus phase, ``mu_dtype="bfloat16"``. Shared
set-up: `tests/test_torch_training_cli.py`.

Limits: losses 1e-4 of scale and parameters 1e-5, as there. Through the focus
phase the main optimizer's moments are exactly ``b^k`` times their value
before it (``(1 - b) * 0 + b * m`` is ``b * m`` in both packages) and within
the gradients' 1e-4 of optax's (they hold the gradient of the full update
before), its count and schedule exact. The bf16 first moment element by
element within 2^-6 of itself (two bf16 ulps: a rounding of gradients summed
in another order can land an ulp away, and three updates carry it) or 1e-3
of scale; the parameters beside it within 5e-5 of scale (a moment an ulp away
moves its element's update by up to 2^-8 of the rate); on the same gradients
the first moment is bit for bit optax's, the second moment and the parameters
within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eraxvif5tts_tpu.training import trainer as jtr
from eraxvif5tts_tpu_torch.models.duration import duration_state_dict_from_jax
from eraxvif5tts_tpu_torch.training import trainer as ttr
from test_torch_models import close
from test_torch_training import _batch, _jax_draws, _jax_params, _port_cfm, _torch_grads
from test_torch_training_cli import _close_tree, _phoneme_batch, _trainers


def test_curriculum_with_gradient_accumulation_matches_jax():
    """k = 2 (both optimizers through ``optax.MultiSteps`` in JAX): two focus
    micro-batches make one update of the state alone, two full ones one
    update of both models; each micro-batch's losses and the applied flags,
    then the parameters, the predictor and the EMA as the JAX trainer's."""
    jt, jstate, trainer, state, _ = _trainers(focus_updates=1, accumulate=2)
    params0 = {k: v.detach().clone() for k, v in state.params.items()}
    applied = []
    for i in range(4):
        batch, rng = _phoneme_batch(10 + i), jax.random.key(20 + i)
        jstate, jm = jt.train_step(jstate, batch, rng)
        state, m = trainer.train_step(state, batch, _jax_draws(rng, 2, 16))
        for key in ("loss", "cfm_loss", "duration_loss", "duration_mae", "grad_norm"):
            close(m[key], float(jm[key]), 1e-4, f"micro-batch {i} {key}")
        assert m["applied"] == float(jm["applied"])
        applied.append(m["applied"])
        if i == 1:  # the focus update: the backbone bit for bit
            for k, v in state.params.items():
                assert torch.equal(v, params0[k]), k
    assert applied == [0.0, 1.0, 0.0, 1.0]
    assert state.step == int(jstate.step) == 2 and state.mini_step == state.dur_mini_step == 0
    _close_tree(dict(state.dur_predictor.named_parameters()),
                duration_state_dict_from_jax(jstate.dur_pred_params), 1e-5, "dur param")
    _close_tree(state.params, _torch_grads(jstate.params), 1e-5, "param")
    _close_tree(state.ema_params, _torch_grads(jstate.ema_params), 1e-5, "ema")


def test_focus_phase_leaves_the_backbone_and_advances_optax_state():
    """One full update (moments non-zero), then two focus updates: the
    backbone bit for bit, the moments ``b1^2 m`` / ``b2^2 v``, the counts 3,
    the schedule at 3, as optax's on zero gradients."""
    jt, jstate, trainer, state, _ = _trainers(focus_updates=0)
    batch, rng = _phoneme_batch(10), jax.random.key(20)
    jstate, _ = jt.train_step(jstate, batch, rng)
    state, _ = trainer.train_step(state, batch, _jax_draws(rng, 2, 16))
    for t in (jt, trainer):
        t.alignment_manager.phase = 1
        t.duration_focus_updates = 10**6
    after_full = {k: v.detach().clone() for k, v in state.params.items()}
    opt = state.optimizer
    moments = {k: [opt.state[p][m].clone() for m in ("exp_avg", "exp_avg_sq")]
               for k, p in state.model.named_parameters()}
    for i in range(2):
        batch, rng = _phoneme_batch(11 + i), jax.random.key(21 + i)
        jstate, jm = jt.train_step(jstate, batch, rng)
        state, m = trainer.train_step(state, batch, _jax_draws(rng, 2, 16))
        assert m["grad_norm"] == 0.0 and m["applied"] == 1.0
    for k, v in state.params.items():
        assert torch.equal(v, after_full[k]), k
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: type(x).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState")
    assert int(adam.count) == 3 and state.step == 3
    params = dict(state.model.named_parameters())
    got_mu = {k: opt.state[p]["exp_avg"] for k, p in params.items()}
    got_nu = {k: opt.state[p]["exp_avg_sq"] for k, p in params.items()}
    assert all(opt.state[p]["step"].item() == 3 for p in params.values())
    for k, (mu, nu) in moments.items():
        assert torch.equal(got_mu[k], mu * 0.9 * 0.9) and torch.equal(got_nu[k], nu * 0.98 * 0.98)
    _close_tree(got_mu, _torch_grads(adam.mu), 1e-4, "mu")
    _close_tree(got_nu, _torch_grads(adam.nu), 1e-4, "nu")
    assert state.scheduler.last_epoch == 3
    np.testing.assert_allclose(opt.param_groups[0]["lr"],
                               float(optax.linear_schedule(1e-3, 0.0, 9)(2)), rtol=1e-6)


def test_mu_dtype_bfloat16_moments_match_optax():
    jcfm, params = _jax_params(seed=1)
    spec = dict(learning_rate=1e-3, num_warmup_updates=1, total_updates=10)
    jt = jtr.Trainer(cfm=jcfm, optimizer=jtr.make_optimizer(**spec, mu_dtype=jnp.bfloat16),
                     ema_update_after_step=0, ema_update_every=1)
    jstate = jt.init_state(jax.random.key(0), params=params)
    trainer = ttr.Trainer(cfm=_port_cfm(params),
                          optimizer=ttr.make_optimizer(**spec, mu_dtype="bfloat16"),
                          ema_update_after_step=0, ema_update_every=1)
    state = trainer.init_state()
    assert isinstance(state.optimizer, ttr.AdamWBf16Mu)
    for i in range(3):
        batch, rng = _batch(seed=10 + i, lens=[16, 13]), jax.random.key(20 + i)
        jstate, jm = jt.train_step(jstate, batch, rng)
        state, m = trainer.train_step(state, batch, _jax_draws(rng, 2, 16))
        close(m["loss"], float(jm["loss"]), 1e-4, f"loss {i}")
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: type(x).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState")
    params = dict(state.model.named_parameters())
    got_mu = {k: state.optimizer.state[p]["exp_avg"] for k, p in params.items()}
    assert all(v.dtype == torch.bfloat16 for v in got_mu.values())
    assert all(np.asarray(v).dtype == jnp.bfloat16 for v in jax.tree.leaves(adam.mu))
    want_mu = _torch_grads(jax.tree.map(lambda x: np.asarray(x, np.float32), adam.mu))
    for k, w in want_mu.items():
        np.testing.assert_allclose(got_mu[k].float().numpy(), w, rtol=2**-6,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)
    _close_tree({k: state.optimizer.state[p]["exp_avg_sq"] for k, p in params.items()},
                _torch_grads(adam.nu), 1e-4, "nu")
    _close_tree(state.params, _torch_grads(jstate.params), 5e-5, "param")
    with pytest.raises(ValueError, match="mu_dtype"):
        ttr.make_optimizer(mu_dtype="float16")


def test_bf16_moment_step_equals_optax_on_the_same_gradients():
    rng = np.random.default_rng(0)
    p0 = (0.1 * rng.standard_normal((64, 32))).astype(np.float32)
    jopt = jtr.make_optimizer(1e-3, 1, 10, mu_dtype=jnp.bfloat16)
    jp = {"w": jnp.asarray(p0)}
    js, update = jopt.init(jp), jax.jit(jopt.update)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = ttr.make_optimizer(1e-3, 1, 10, mu_dtype="bfloat16").build([p])
    for scale in (0.005, 0.002, 0.004):  # global norms below the clip
        g = (scale * rng.standard_normal(p0.shape)).astype(np.float32)
        u, js = update({"w": jnp.asarray(g)}, js, jp)
        jp = optax.apply_updates(jp, u)
        p.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
    adam = next(s for s in jax.tree_util.tree_leaves(
        js, is_leaf=lambda x: type(x).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState")
    np.testing.assert_array_equal(opt.state[p]["exp_avg"].float().numpy(),
                                  np.asarray(adam.mu["w"], np.float32))
    np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(), np.asarray(adam.nu["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp["w"]), rtol=1e-6)
