"""PyTorch port, distillation: `distillation_losses`, `duration_loss_from_attn`
and `DistillTrainer` against the JAX package on the same weights, batches and
random draws, kill-and-resume, and the exported student served by both
packages' wrappers.

The teacher is a tiny DiT of depth 4 (the `TDiT` widths of
`tests/test_checkpoint_parity.py`: dim 64, 2 heads x 32, text_dim 32, one
conv layer) with every leaf redrawn from a seeded normal; the student is that
teacher pruned to blocks [0, 3] by the JAX pruner, trained at dropout 0.1.
The JAX loss's draws are taken with `jax.random` in its order and handed to
the port; the dropout keys are the ones the JAX student's `make_rng` gives
each site, read off a forward in which the JAX attention takes the
position-hash mask of its TPU kernel (`ops/train_attention.dense_reference`,
the kernel's own test oracle): on the CPU the JAX package otherwise draws
`jax.random.bernoulli` masks, which no port can reproduce.

Tolerances, relative to each tensor's scale, as `tests/test_torch_training.py`
holds `CFM.loss`: losses and gradients 1e-4; parameters, EMA and predictor
parameters after three steps 1e-5; the port against itself after a resume
exact; the exported student's int16 PCM in both wrappers within 4 LSB (the
slice's tolerance, `tests/test_torch_slice.py`). The L1 terms are held in the
loss test; the trainer runs the default (MSE) recipe: a pruned student sits
close to its teacher, L1's gradient is the sign of their difference, and at
a near tie (|student - teacher| ~ 1e-7, two of 2,200 span elements in one of
these batches) the two frameworks' last-bit roundings pick opposite signs,
which AdamW then turns into full-size steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.compression import convert as jconvert
from eraxvif5tts_tpu.compression.pruner import prune_state_dict as j_prune_state_dict
from eraxvif5tts_tpu.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu.models import modules as jmodules
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu.models.duration import DurationPredictor as JDurationPredictor
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu.ops import train_attention as jta
from eraxvif5tts_tpu.training import distill as jdistill
from eraxvif5tts_tpu.training import trainer as jtr
from eraxvif5tts_tpu_torch.compression.convert import state_dict_from_jax
from eraxvif5tts_tpu_torch.models.cfm import CFM, LossDraws
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.models.duration import (
    DurationPredictor,
    duration_state_dict_from_jax,
    predictor_vocab_size,
)
from eraxvif5tts_tpu_torch.training import distill as tdistill
from eraxvif5tts_tpu_torch.training import trainer as ttr
from test_torch_models import close, redraw

MEL = 100
VOCAB_CHARS = list(" abcdefghij.")
T_ARCH = ArchConfig(dim=64, depth=4, heads=2, dim_head=32, ff_mult=2, text_dim=32,
                    conv_layers=1, dropout=0.0)
S_ARCH = dataclasses.replace(T_ARCH, depth=2, dropout=0.1)
KEEP = [0, 3]
DUR_VOCAB = predictor_vocab_size(len(VOCAB_CHARS))
B, N = 2, 16


# ---------------------------------------------------------------------------
# shared weights and batches


@pytest.fixture(scope="module")
def weights():
    """(teacher params, student params, predictor params): JAX trees of numpy
    leaves; the student is the teacher pruned to KEEP."""
    teacher = JDiT(arch=T_ARCH, text_num_embeds=len(VOCAB_CHARS), mel_dim=MEL)
    t_params = redraw(JCFM(transformer=teacher).init_params(jax.random.key(0)), 30, std=0.05)
    torch_layout = jconvert.dit_params_to_torch(t_params, depth=4, conv_layers=1)
    s_params = jconvert.dit_params_from_torch(j_prune_state_dict(torch_layout, KEEP),
                                              depth=2, conv_layers=1)
    dp = JDurationPredictor(vocab_size=DUR_VOCAB, d_model=16, d_filter=16)
    ids = jnp.zeros((1, 8), jnp.int32)
    dp_params = redraw(jax.jit(dp.init)(jax.random.key(4), ids, ids > 0)["params"], 31, std=0.3)
    return t_params, jax.tree.map(np.asarray, s_params), dp_params


def _batch(seed=0, nan=False):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, N, MEL)).astype(np.float32)
    if nan:
        mel[0, 0, 0] = np.nan
    text = np.asarray([[1, 2, 5, -1], [3, 1, -1, -1]], np.int32)
    # a monotonic alignment: each valid token a run of frames
    attn = np.zeros((B, text.shape[1], N), np.float32)
    attn[0, 0, :5], attn[0, 1, 5:9], attn[0, 2, 9:16] = 1.0, 1.0, 1.0
    attn[1, 0, :7], attn[1, 1, 7:12] = 1.0, 1.0
    return {"mel": mel, "text": text, "lens": np.asarray([N, 12], np.int32), "attn": attn}


def _port_models(weights, student_dropout=S_ARCH.dropout):
    t_params, s_params, dp_params = weights
    teacher = DiT(T_ARCH, len(VOCAB_CHARS), MEL)
    teacher.load_state_dict(state_dict_from_jax(t_params, None, ModelConfig(arch=T_ARCH))[0])
    arch = dataclasses.replace(S_ARCH, dropout=student_dropout)
    student = DiT(arch, len(VOCAB_CHARS), MEL)
    student.load_state_dict(state_dict_from_jax(s_params, None, ModelConfig(arch=arch))[0])
    predictor = DurationPredictor(DUR_VOCAB, d_model=16, d_filter=16)
    predictor.load_state_dict(duration_state_dict_from_jax(dp_params))
    return teacher.eval(), CFM(student.train()), predictor


def _jax_models(student_dropout=S_ARCH.dropout):
    teacher = JDiT(arch=T_ARCH, text_num_embeds=len(VOCAB_CHARS), mel_dim=MEL)
    arch = dataclasses.replace(S_ARCH, dropout=student_dropout)
    student = JCFM(transformer=JDiT(arch=arch, text_num_embeds=len(VOCAB_CHARS), mel_dim=MEL))
    return teacher, student, JDurationPredictor(vocab_size=DUR_VOCAB, d_model=16, d_filter=16)


# ---------------------------------------------------------------------------
# the JAX draws and dropout keys, handed to the port


_RECORDED: list = []


def _hash_attention(q, k, v, key_valid=None, dropout_rate=0.0, dropout_rng=None, **_):
    """The JAX training attention with its TPU kernel's position-hash mask
    (the seed derived from the key as `train_attention` derives it)."""
    kd = jax.random.key_data(dropout_rng).reshape(-1)
    _RECORDED.append(kd)
    seed = (jta._fmix32(kd[0].astype(jnp.uint32))
            ^ jta._fmix32(kd[-1].astype(jnp.uint32) + jnp.uint32(0x9E3779B9)))
    return jta.dense_reference(q, k, v, key_valid=key_valid, dropout_rate=dropout_rate,
                               seed=seed)


@pytest.fixture(autouse=True)
def hash_masks(monkeypatch):
    """Every JAX dropout site of this module's tests on the position hash,
    and each site's key recorded in trace order."""
    plain = jmodules.hash_dropout

    def recorded_dropout(x, rate, rng):
        _RECORDED.append(jax.random.key_data(rng).reshape(-1))
        return plain(x, rate, rng)

    monkeypatch.setattr(jmodules, "chunked_dot_product_attention", _hash_attention)
    monkeypatch.setattr(jmodules, "hash_dropout", recorded_dropout)


def _key_recorder(jmodels, weights, cfg):
    """A jitted ``(mel, text, lens, rng) -> keys``: per student block, the
    (attention, attention output, FF) keys that the JAX student's dropout
    sites take in that loss, as the port's 32-bit word pairs."""
    jteacher, jstudent, _ = jmodels
    t_params, s_params, _ = weights

    def traced(mel, text, lens, rng):
        _RECORDED.clear()
        jdistill.distillation_losses(jstudent, s_params, jteacher, t_params, mel, text, lens,
                                     rng, cfg, deterministic=False)
        return list(_RECORDED)

    record = jax.jit(traced)

    def keys(batch, rng):
        words = [[int(w) for w in np.asarray(kd)]
                 for kd in record(batch["mel"], batch["text"], batch["lens"], rng)]
        assert len(words) == 3 * S_ARCH.depth
        return [words[3 * i:3 * i + 3] for i in range(S_ARCH.depth)]

    return keys


def _jax_draws(rng, keys=None) -> LossDraws:
    """The JAX loss's draws (`distill.py:53-83`), in its order."""
    k_frac, k_span, k_x0, k_t, k_a, k_c, _ = jax.random.split(rng, 7)

    def t(a):
        return torch.from_numpy(np.array(a))

    return LossDraws(frac=t(jax.random.uniform(k_frac, (B,), minval=0.7, maxval=1.0)),
                     rand=t(jax.random.uniform(k_span, (B,))),
                     x0=t(jax.random.normal(k_x0, (B, N, MEL), jnp.float32)),
                     time=t(jax.random.uniform(k_t, (B,), dtype=jnp.float32)),
                     drop_audio=t(jax.random.uniform(k_a, ())),
                     drop_cond=t(jax.random.uniform(k_c, ())), dropout_keys=keys)


def _torch_layout(tree, depth):
    return jconvert.backbone_params_to_torch(tree, "DiT", depth, 1, with_prefix=False)


def _tensors(batch):
    return [torch.from_numpy(batch[k]) for k in ("mel", "text", "lens")]


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dropout,cfg", [
    (0.0, jdistill.DistillConfig()),
    (0.1, jdistill.DistillConfig(distill_loss_type="l1", spec_l1_weight=0.3,
                                 distill_loss_weight=0.7)),
])
def test_distillation_losses_and_gradients_match_jax(weights, dropout, cfg):
    t_params, s_params, _ = weights
    jteacher, jstudent, _ = jmodels = _jax_models(dropout)
    batch, rng = _batch(seed=3), jax.random.key(11)

    def loss(p):
        total, metrics = jdistill.distillation_losses(
            jstudent, p, jteacher, t_params, batch["mel"], batch["text"], batch["lens"], rng,
            cfg, deterministic=False)
        return total, metrics

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(s_params)
    draws = _jax_draws(rng, _key_recorder(jmodels, weights, cfg)(batch, rng) if dropout
                       else None)
    teacher, cfm, _ = _port_models(weights, dropout)
    total, got = tdistill.distillation_losses(cfm, teacher, *_tensors(batch), draws,
                                              tdistill.DistillConfig(**dataclasses.asdict(cfg)))
    total.backward()
    assert set(got) == set(want) == {"loss", "student_loss", "distill_loss", "spec_l1"}
    for name in got:
        close(got[name].item(), float(want[name]), 1e-4, name)
    assert all(p.grad is None for p in teacher.parameters())
    params = dict(cfm.transformer.named_parameters())
    for name, g in _torch_layout(jgrads, S_ARCH.depth).items():
        close(params[name].grad.numpy(), g, 1e-4, f"grad {name}")


def test_duration_loss_from_attn_matches_jax(weights):
    _, _, dp_params = weights
    _, _, jdp = _jax_models()
    batch = _batch()
    text = jnp.asarray(batch["text"])
    text_lens = jnp.sum(text != -1, axis=-1)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jdistill.duration_loss_from_attn(jdp, p, text, text_lens, batch["attn"])))(
        dp_params)
    _, _, predictor = _port_models(weights)
    ttext = torch.from_numpy(batch["text"]).long()
    got = tdistill.duration_loss_from_attn(predictor, ttext, (ttext != -1).sum(-1),
                                           torch.from_numpy(batch["attn"]))
    got.backward()
    close(got.item(), float(want), 1e-4, "duration loss")
    grads = {k: p.grad for k, p in predictor.named_parameters()}
    for name, g in duration_state_dict_from_jax(jax.tree.map(np.asarray, jgrads)).items():
        close(grads[name].numpy(), g.numpy(), 1e-4, f"grad {name}")


SPEC = dict(learning_rate=1e-3, num_warmup_updates=1, total_updates=10, decay_type="cosine")
RECIPE = dict(ema_decay=0.5, ema_update_after_step=1, ema_update_every=1, duration_lr=3e-3)


def _jax_trainer(weights):
    _, s_params, dp_params = weights
    jteacher, jstudent, jdp = jmodels = _jax_models()
    jt = jdistill.DistillTrainer(student_cfm=jstudent, teacher_transformer=jteacher,
                                 optimizer=jtr.make_optimizer(**SPEC), duration_predictor=jdp,
                                 config=jdistill.DistillConfig(), **RECIPE)
    return jt, jt.init_state(jax.random.key(0), params=s_params, dur_pred_params=dp_params), jmodels


def _port_trainer(weights, tmp_path=None):
    """The port's DistillTrainer on the same weights and recipe as `_jax_trainer`."""
    teacher, cfm, predictor = _port_models(weights)
    pt = tdistill.DistillTrainer(student_cfm=cfm, teacher_transformer=teacher,
                                 optimizer=ttr.make_optimizer(**SPEC),
                                 duration_predictor=predictor,
                                 config=tdistill.DistillConfig(),
                                 checkpoint_dir=str(tmp_path) if tmp_path else None, **RECIPE)
    return pt, pt.init_state()


def test_three_distill_steps_and_a_nan_batch_match_jax_trainer(weights):
    """Steps with the duration loss (`batch['attn']`), a NaN batch skipped
    between them (the loss alone decides; the EMA still runs at the unchanged
    step), then a step without `attn` (the predictor left alone)."""
    t_params, _, _ = weights
    jt, jstate, jmodels = _jax_trainer(weights)
    pt, state = _port_trainer(weights)
    keys = _key_recorder(jmodels, weights, jt.config)
    plan = [(_batch(seed=20), True), (_batch(seed=21, nan=True), True),
            (_batch(seed=22), True), (_batch(seed=23), False)]
    for i, (batch, with_attn) in enumerate(plan):
        if not with_attn:
            batch = {k: v for k, v in batch.items() if k != "attn"}
        rng = jax.random.key(40 + i)
        draws = _jax_draws(rng, keys(batch, rng))
        jstate, jm = jt.train_step(jstate, t_params, batch, rng)
        state, m = pt.train_step(state, batch, draws)
        assert m["skipped"] == float(jm["skipped"]) == float(i == 1)
        assert ("duration_loss" in m) == ("duration_loss" in jm) == with_attn
        for name in m:
            if name != "skipped" and np.isfinite(float(jm[name])):
                close(m[name], float(jm[name]), 1e-4, f"step {i} {name}")
        assert np.isfinite(m["loss"]) == (i != 1)
        assert state.step == int(jstate.step)
    assert state.step == 3
    for name, want in _torch_layout(jstate.params, S_ARCH.depth).items():
        close(state.params[name].detach().numpy(), want, 1e-5, f"param {name}")
    for name, want in _torch_layout(jstate.ema_params, S_ARCH.depth).items():
        close(state.ema_params[name].numpy(), want, 1e-5, f"ema {name}")
    want_dur = duration_state_dict_from_jax(jax.tree.map(np.asarray, jstate.dur_pred_params))
    got_dur = state.dur_predictor.state_dict()
    for name, want in want_dur.items():
        close(got_dur[name].numpy(), want.numpy(), 1e-5, f"predictor {name}")


def test_distill_kill_and_resume_matches_uninterrupted(weights, tmp_path):
    """Stop after 2 steps, checkpoint, resume in a new trainer: the last two
    steps give the uninterrupted run's student, EMA and predictor exactly
    (`tests/test_distill_production.py:54`)."""
    batches = [_batch(seed=50 + i) for i in range(4)]

    def run(steps, trainer, state, start=0):
        for i in range(start, start + steps):
            state, _ = trainer.train_step(state, batches[i],
                                          torch.Generator().manual_seed(ttr.batch_seed(7, 0, i)))
        return state

    full, s_full = _port_trainer(weights, tmp_path / "full")
    s_full = run(4, full, s_full)

    first, s_int = _port_trainer(weights, tmp_path / "int")
    s_int = run(2, first, s_int)
    first.save_checkpoint(s_int, meta={"epoch": 0, "batch_in_epoch": 2})

    second, template = _port_trainer(weights, tmp_path / "int")
    restored = second.load_checkpoint(ttr.latest_checkpoint(str(tmp_path / "int")), template)
    assert second.resume_meta == {"epoch": 0, "batch_in_epoch": 2} and restored.step == 2
    restored = run(2, second, restored, start=2)
    assert restored.step == s_full.step == 4
    for k, v in restored.params.items():
        assert torch.equal(v, s_full.params[k]), k
    for k, v in restored.ema_params.items():
        assert torch.equal(v, s_full.ema_params[k]), k
    for (k, v), w in zip(restored.dur_predictor.state_dict().items(),
                         s_full.dur_predictor.state_dict().values()):
        assert torch.equal(v, w), k
    # a checkpoint without the predictor's state is refused by a state with one
    plain = ttr.Trainer(cfm=_port_models(weights)[1], optimizer=ttr.make_optimizer(),
                        checkpoint_dir=str(tmp_path / "plain"))
    path = plain.save_checkpoint(plain.init_state())
    with pytest.raises(ValueError, match="no duration-predictor state"):
        second.load_checkpoint(path, template)


def test_exported_student_serves_in_both_wrappers(weights, tmp_path):
    """The port's EMA export loads strict in the port wrapper and in the JAX
    wrapper (reference `.pt` layout); on the same sampler noise both give the
    same PCM."""
    from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    pt, state = _port_trainer(weights)
    state, _ = pt.train_step(state, _batch(seed=60), torch.Generator().manual_seed(3))
    path = pt.export_student_torch(state, str(tmp_path / "student.pt"), depth=S_ARCH.depth,
                                   conv_layers=S_ARCH.conv_layers)
    with pytest.raises(ValueError, match="depth=3 but the student has 2"):
        pt.export_student_torch(state, str(tmp_path / "x.pt"), depth=3)

    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, MEL, 8)))
                     ["params"], seed=32, std=0.05)
    vparams["head_out"]["bias"] += 2.0
    cfg = ModelConfig(name="student", arch=dataclasses.replace(S_ARCH, dropout=0.0))
    buckets = dict(duration_buckets=(128, 192, 256), text_buckets=(64,))
    jw = JWrapper(model_cfg=cfg, ckpt_path=path, vocab_char_map=vocab, nfe_step=3,
                  vocoder_params=vparams, compute_dtype="float32", **buckets)
    tw = F5TTSWrapper(model_cfg=cfg, ckpt_path=path, vocab_char_map=vocab, nfe_step=3,
                      vocoder_params=vparams, compute_dtype="float32", device="cpu", **buckets)
    assert tw.config.arch.depth == jw.config.arch.depth == S_ARCH.depth
    close(np.asarray(jw.params["block_1"]["attn"]["to_q"]["kernel"]),
          state.ema_params["transformer_blocks.1.attn.to_q.weight"].numpy().T, 1e-7, "to_q")
    for name, p in tw.transformer.state_dict().items():
        assert torch.equal(p, state.ema_params[name]), name

    t = np.arange(int(24000 * 0.8)) / 24000
    audio = (0.2 * np.sin(2 * np.pi * 190 * t)).astype(np.float32)
    jref = jw.preprocess_reference(ref_audio=audio, ref_sample_rate=24000, ref_text="abc def")
    tref = tw.preprocess_reference(ref_audio=audio, ref_sample_rate=24000, ref_text="abc def")
    draws = []

    def jax_noise(self, generator, n_frames):
        key = jax.random.fold_in(jax.random.key(9), len(draws))
        draws.append(n_frames)
        return torch.from_numpy(np.array(jax.random.normal(key, (n_frames, MEL), jnp.float32)))

    tw._draw_noise = jax_noise.__get__(tw)
    want = jw.generate("ab cd.", ref=jref, seed=9, use_pinyin=False)
    got = tw.generate("ab cd.", ref=tref, seed=9, use_pinyin=False)
    assert got.shape == want.shape and len(got) > 0 and draws
    assert np.abs(want).max() > 1000 / 32767.0
    assert np.abs(got - want).max() <= 4 / 32767.0


@pytest.mark.parametrize("with_mask", [False, True])
def test_eval_forward_hands_the_serving_kernels_contiguous_rows(weights, monkeypatch, with_mask):
    """The teacher's forward (eval, no mask: `lens=None`) gives the
    normalised projection kernel and the attention kernel the contiguous rows
    their CUDA wrappers require. Without a mask the conv position embedding
    returned its transposed conv output, the residual stream took that
    layout, and kernel 2 raised on the card (the CPU's plain versions take
    any layout, so this checks the layout itself)."""
    from eraxvif5tts_tpu_torch.models import modules
    from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask

    seen = []
    plain_ln, plain_attn = modules.ln_mod_matmul, modules.dot_product_attention

    def ln(x, *args, **kwargs):
        seen.append(x.is_contiguous())
        return plain_ln(x, *args, **kwargs)

    def attn(q, k, v, *args, **kwargs):
        seen.extend(t.is_contiguous() for t in (q, k, v))
        return plain_attn(q, k, v, *args, **kwargs)

    monkeypatch.setattr(modules, "ln_mod_matmul", ln)
    monkeypatch.setattr(modules, "dot_product_attention", attn)
    teacher, _, _ = _port_models(weights)
    # in bf16, the teacher's serving dtype on the card: an fp32 block takes the
    # unfused feed-forward and never calls kernel 2
    teacher = teacher.to(torch.bfloat16)
    batch = _batch()
    mel, text, lens = _tensors(batch)
    no_drop = torch.zeros(B, dtype=torch.bool)
    mask = lens_to_mask(lens, N) if with_mask else None
    with torch.no_grad():
        teacher(mel, mel, text, torch.full((B,), 0.4), no_drop, no_drop, mask=mask)
    assert len(seen) == 4 * T_ARCH.depth and all(seen)
