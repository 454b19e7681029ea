"""PyTorch port, MMDiT training and kernel 4's joint domain: the MMDiT's
`CFM.loss`, prediction and every gradient, in fp32 and in bf16 compute, and
three `Trainer` steps, against the JAX package on the same weights (every
JAX leaf redrawn from a seeded normal, carried across by `state_dict_from_jax`),
batches and random draws (taken with `jax.random` in the JAX loss's order);
the refusal of dropout > 0 in both packages; the training attention's domain
widened to the joint sequence (n <= 6144): its geometries walked over every
n, its argument checks and the keep mask at the far corner of a 6144 x 6144
head bit for bit against the JAX one.

Tiny MMDiT (dim 128, 2 x 64 heads, ff_mult 2), texts of 8 and 5 tokens
padded with -1 to 16. Tolerances, relative to each tensor's scale: loss,
prediction and gradients 1e-4 (the backward sums in other orders; the DiT
training test's); parameters after three steps 1e-4 everywhere and 1e-5 on
all but 1e-3 of the elements (`_adam_close` says why); bf16 compute 2e-2
(bf16 rounding through the blocks, the bf16 DiT's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.compression.convert import backbone_params_to_torch
from eraxvif5tts_tpu.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu.models import mmdit as jmmdit
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.ops import train_attention as jta
from eraxvif5tts_tpu.training import trainer as jtr
from eraxvif5tts_tpu_torch.compression.convert import state_dict_from_jax
from eraxvif5tts_tpu_torch.models import build_backbone
from eraxvif5tts_tpu_torch.models.cfm import CFM, LossDraws
from eraxvif5tts_tpu_torch.models.mmdit import MMDiT
from eraxvif5tts_tpu_torch.ops import serving_attention as tsa
from eraxvif5tts_tpu_torch.ops import train_attention as tta
from eraxvif5tts_tpu_torch.training import trainer as ttr
from test_torch_models import close, redraw

MEL = 16
VOCAB = 24
B, N, NT = 2, 32, 16
ARCH = ArchConfig(dim=128, depth=3, heads=2, dim_head=64, ff_mult=2, dropout=0.0)
CFG = ModelConfig(name="tiny-mmdit", backbone="MMDiT", arch=ARCH)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for a file of tiny tensors (this one and the int8
    MMDiT's): beside other test processes, torch's thread pool on every core
    spends its time waiting (these tests ran 20 to 40 times slower under a
    parallel run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arch(qk_norm=None, depth=3, dropout=0.0):
    return dataclasses.replace(ARCH, qk_norm=qk_norm, depth=depth, dropout=dropout)


def _jax_cfm(arch, compute_dtype=jnp.float32):
    return JCFM(transformer=jmmdit.MMDiT(arch=arch, text_num_embeds=VOCAB, mel_dim=MEL,
                                         compute_dtype=compute_dtype))


def _jax_params(arch, seed=60):
    return redraw(_jax_cfm(arch).init_params(jax.random.key(0)), seed)


def _port_cfm(params, arch, compute_dtype=None) -> CFM:
    cfg = dataclasses.replace(CFG, arch=arch)
    net = MMDiT(arch, VOCAB, MEL, compute_dtype=compute_dtype)
    net.load_state_dict(state_dict_from_jax(params, None, cfg)[0], strict=True)
    return CFM(net.train())


def _batch(seed=0, lens=(N, N - 9)):
    rng = np.random.default_rng(seed)
    text = np.full((B, NT), -1, np.int32)
    text[0, :8] = rng.integers(0, VOCAB, 8)
    text[1, :5] = rng.integers(0, VOCAB, 5)
    return {"mel": rng.standard_normal((B, N, MEL)).astype(np.float32), "text": text,
            "lens": np.asarray(lens, np.int32)}


def _jax_draws(rng, lo=0.7, hi=1.0) -> LossDraws:
    """The JAX loss's draws (`cfm.py:105-127`), in its order."""
    k_frac, k_span, k_x0, k_t, k_a, k_c, _ = jax.random.split(rng, 7)

    def t(a):
        return torch.from_numpy(np.array(a))

    return LossDraws(frac=t(jax.random.uniform(k_frac, (B,), minval=lo, maxval=hi)),
                     rand=t(jax.random.uniform(k_span, (B,))),
                     x0=t(jax.random.normal(k_x0, (B, N, MEL), jnp.float32)),
                     time=t(jax.random.uniform(k_t, (B,), dtype=jnp.float32)),
                     drop_audio=t(jax.random.uniform(k_a, ())),
                     drop_cond=t(jax.random.uniform(k_c, ())))


def _torch_tree(jtree, arch):
    return backbone_params_to_torch(jtree, "MMDiT", arch.depth, 0,
                                    qk_norm=arch.qk_norm == "rms_norm", with_prefix=False)


def _port_loss(cfm, batch, draws):
    return cfm.loss(*(torch.from_numpy(batch[k]) for k in ("mel", "text", "lens")), draws)


# ---------------------------------------------------------------------------
# CFM.loss and its gradients


@pytest.mark.parametrize("qk_norm", [None, "rms_norm"])
def test_mmdit_loss_and_gradients_match_jax(qk_norm):
    """Loss, cond, prediction and every parameter's gradient against
    `jax.value_and_grad` of the JAX MMDiT's `CFM.loss` at dropout 0, with a
    frame-padded second sample (the loss, like the JAX one, runs the backbone
    unmasked)."""
    arch = _arch(qk_norm)
    jcfm, params = _jax_cfm(arch), _jax_params(arch)
    batch, rng = _batch(seed=2), jax.random.key(5)
    (want_loss, (want_cond, want_pred)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda out: (out[0], out[1:]))(jcfm.loss(p, batch["mel"], batch["text"],
                                                            batch["lens"], rng)),
        has_aux=True))(params)
    cfm = _port_cfm(params, arch)
    loss, cond, pred = _port_loss(cfm, batch, _jax_draws(rng))
    loss.backward()
    close(loss.item(), float(want_loss), 1e-4, "loss")
    close(cond.numpy(), want_cond, 1e-6, "cond")
    close(pred.detach().numpy(), want_pred, 1e-4, "pred")
    want = _torch_tree(jgrads, arch)
    got = dict(cfm.transformer.named_parameters())
    assert set(got) == set(want)
    # the last block's text queries answer nothing: its text stream ends
    # with the attention's input (`context_pre_only`), so their gradient is 0
    idle = {f"transformer_blocks.{arch.depth - 1}.attn.{name}.{param}"
            for name in ("to_q_c", "c_q_norm") for param in ("weight", "bias")}
    for name, g in want.items():
        assert (np.abs(g).max() == 0) == (name in idle), name
        close(got[name].grad.numpy(), g, 1e-4, f"grad {name}")


def test_mmdit_loss_bf16_compute_matches_jax():
    """The card's recipe, fp32 parameters and bf16 compute (`proj_out` in
    fp32, as a flax Dense without a dtype): loss, prediction and the whole
    gradient against the JAX MMDiT with ``compute_dtype=bfloat16``, within
    bf16 rounding. Without ``qk_norm``: the JAX MMDiT in bf16 with it hands
    XLA's attention fp32 q, k and bf16 v, which it refuses on the CPU."""
    arch = _arch(depth=2)
    jcfm, params = _jax_cfm(arch, jnp.bfloat16), _jax_params(arch, seed=61)
    batch, rng = _batch(seed=6, lens=(N, N - 4)), jax.random.key(2)
    (want_loss, want_pred), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda out: (out[0], out[2]))(jcfm.loss(p, batch["mel"], batch["text"],
                                                           batch["lens"], rng)),
        has_aux=True))(params)
    cfm = _port_cfm(params, arch, torch.bfloat16)
    loss, _, pred = _port_loss(cfm, batch, _jax_draws(rng))
    loss.backward()
    net = cfm.transformer
    assert pred.dtype == torch.float32 and net.proj_out.weight.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    close(pred.detach().numpy(), want_pred, 2e-2, "pred bf16")
    close(loss.item(), float(want_loss), 2e-2, "loss bf16")
    # the whole gradient, flattened: relative L2 within bf16 rounding (a
    # single bias alone moves by up to ~2e-2 of its scale)
    grads = dict(net.named_parameters())
    want = _torch_tree(jgrads, arch)
    got = np.concatenate([grads[name].grad.numpy().ravel() for name in want])
    flat = np.concatenate([np.asarray(g, np.float32).ravel() for g in want.values()])
    rel = np.linalg.norm(got - flat) / np.linalg.norm(flat)
    assert rel <= 2e-2, f"bf16 gradient: relative L2 error {rel:.3g}"


def _adam_close(got, want, what):
    """Parameters after AdamW updates: within PARAM_TOL of scale everywhere,
    and all but PARAM_FRACTION of the elements within 1e-5 (the DiT
    trainer test's bound). AdamW divides each update by the gradient's own
    magnitude, so an element whose gradient lies within the two packages'
    fp32 summation noise of zero moves by a different share of the learning
    rate on each side (measured: a gradient of -6.4e-9 against -6.6e-9 moved a
    text-embedding weight by 2.7e-6 more, 1.6e-5 of scale); over five draws of
    this model the worst element was 1.6e-5 to 3.8e-5 of scale, always such
    an element, where the largest update was 1.9e-3."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / max(np.abs(want).max(), 1e-6)
    assert err.max() <= PARAM_TOL, f"{what}: max error {err.max():.3g} of scale > {PARAM_TOL}"
    beyond = float(np.mean(err > 1e-5))
    assert beyond <= PARAM_FRACTION, f"{what}: {beyond:.3g} of the elements beyond 1e-5"


PARAM_TOL = 1e-4
PARAM_FRACTION = 1e-3


def test_three_mmdit_train_steps_match_jax_trainer():
    """Three `Trainer.train_step`s against the JAX `Trainer` on the same
    batches and draws: loss and gradient norm 1e-4 each step, then the
    parameters and the EMA (`_adam_close`)."""
    arch = _arch()
    jcfm, params = _jax_cfm(arch), _jax_params(arch, seed=62)
    spec = dict(learning_rate=1e-3, num_warmup_updates=1, total_updates=10)
    jt = jtr.Trainer(cfm=jcfm, optimizer=jtr.make_optimizer(**spec),
                     ema_update_after_step=0, ema_update_every=1)
    jstate = jt.init_state(jax.random.key(0), params=params)
    trainer = ttr.Trainer(cfm=_port_cfm(params, arch), optimizer=ttr.make_optimizer(**spec),
                          ema_update_after_step=0, ema_update_every=1)
    state = trainer.init_state()
    for i in range(3):
        batch, rng = _batch(seed=10 + i, lens=(N, N - 3 * i - 1)), jax.random.key(20 + i)
        jstate, jm = jt.train_step(jstate, batch, rng)
        state, m = trainer.train_step(state, batch, _jax_draws(rng))
        close(m["loss"], float(jm["loss"]), 1e-4, f"loss {i}")
        close(m["grad_norm"], float(jm["grad_norm"]), 1e-4, f"grad_norm {i}")
        assert m["applied"] == float(jm["applied"]) == 1.0
    assert state.step == int(jstate.step) == 3
    for name, want in _torch_tree(jstate.params, arch).items():
        _adam_close(state.params[name].detach().numpy(), want, f"param {name}")
    for name, want in _torch_tree(jstate.ema_params, arch).items():
        _adam_close(state.ema_params[name].numpy(), want, f"ema {name}")


def test_mmdit_training_takes_the_training_attention_on_the_joint_sequence(monkeypatch):
    """In training mode each block's joint attention is one `train_attention`
    call on the contiguous ``[b, nt + n, h, 64]`` q, k, v at dropout 0, with
    the eval path's prefix key mask; eval mode still takes the serving
    attention; the dropout keys go unused."""
    from eraxvif5tts_tpu_torch.models import mmdit

    arch = _arch(depth=2)
    cfm = _port_cfm(_jax_params(arch), arch)
    calls = []
    real = mmdit.train_attention

    def spy(q, k, v, key_valid=None, dropout_rate=0.0, seed=0):
        calls.append((tuple(q.shape), q.is_contiguous() and k.is_contiguous()
                      and v.is_contiguous(), None if key_valid is None else key_valid.clone(),
                      dropout_rate))
        return real(q, k, v, key_valid, dropout_rate, seed)

    monkeypatch.setattr(mmdit, "train_attention", spy)
    draws = LossDraws.sample(torch.Generator().manual_seed(3), B, N, MEL, arch.depth)
    batch = _batch(seed=4)
    loss = _port_loss(cfm, batch, draws)[0]
    again = _port_loss(cfm, batch, dataclasses.replace(draws, dropout_keys=None))[0]
    assert torch.equal(loss, again)
    assert [c[0] for c in calls] == [(B, NT + N, 2, 64)] * (2 * arch.depth)
    assert all(c[1] and c[2] is None and c[3] == 0.0 for c in calls)
    net = cfm.transformer
    mask = torch.arange(N)[None] < torch.tensor([N, N - 7])[:, None]
    x = torch.from_numpy(batch["mel"])
    te = net.embed_text(torch.from_numpy(batch["text"]).long(), N, torch.zeros(B, dtype=bool))
    calls.clear()
    net.run(x, x, te, torch.full((B,), 0.4), torch.zeros(B, dtype=bool), mask)
    assert len(calls) == arch.depth
    want_valid = torch.cat([torch.ones(B, NT, dtype=torch.bool), mask], dim=1)
    assert all(torch.equal(c[2], want_valid) for c in calls)
    calls.clear()
    with torch.no_grad():
        net.eval().run(x, x, te, torch.full((B,), 0.4), torch.zeros(B, dtype=bool), mask)
    assert calls == []


def test_mmdit_dropout_raises_in_both_packages():
    """At dropout > 0 the JAX MMDiT raises `NameError` (`mmdit.py:157` calls
    `hash_dropout`, which the module never imports) and the port refuses
    with a `ValueError` naming the ROADMAP's queue 3 entry, before any
    attention runs."""
    arch = _arch(depth=2, dropout=0.1)
    jcfm, params = _jax_cfm(arch), _jax_params(_arch(depth=2))
    batch, rng = _batch(seed=8), jax.random.key(1)
    with pytest.raises(NameError, match="hash_dropout"):  # raised while tracing
        jax.jit(lambda p: jcfm.loss(p, batch["mel"], batch["text"], batch["lens"], rng))(params)
    cfm = _port_cfm(params, arch)
    draws = LossDraws.sample(torch.Generator().manual_seed(1), B, N, MEL, arch.depth)
    from eraxvif5tts_tpu_torch.models import mmdit

    def never(*args, **kwargs):
        raise AssertionError("an attention ran before the refusal")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mmdit, "train_attention", never)
        with pytest.raises(ValueError, match="queue 3"):
            _port_loss(cfm, batch, draws)
    # eval mode (serving) takes no dropout: it serves at any configured rate
    with torch.no_grad():
        cfm.transformer.eval()(torch.zeros(1, N, MEL), torch.zeros(1, N, MEL),
                               torch.zeros(1, NT, dtype=torch.long), torch.zeros(1),
                               torch.zeros(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool))


def test_mmdit_preset_trains_at_dropout_0_and_refuses_0_1():
    """`F5TTS_v1_MMDiT` keeps `ArchConfig`'s dropout 0.1, as the JAX preset
    does: built as it is it refuses to train; at dropout 0 it trains (a
    narrow copy of the preset, the widths cut for the CPU)."""
    from eraxvif5tts_tpu_torch.configs import PRESETS

    cfg = PRESETS["F5TTS_v1_MMDiT"]
    assert cfg.arch.dropout == 0.1
    arch = dataclasses.replace(cfg.arch, dim=128, depth=2, heads=2)
    torch.manual_seed(0)
    net = build_backbone(dataclasses.replace(cfg, arch=arch), VOCAB).train()
    x = torch.zeros(1, 64, cfg.mel_spec.n_mel_channels)
    args = (x, x, torch.zeros(1, 8, dtype=torch.long), torch.zeros(1),
            torch.zeros(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="dropout 0.1 is refused"):
        net(*args)
    net.arch = dataclasses.replace(net.arch, dropout=0.0)
    out = net(*args)
    out.square().mean().backward()
    assert out.shape == x.shape and all(p.grad is not None for p in net.parameters())


# ---------------------------------------------------------------------------
# kernel 4's domain: the joint sequence


def test_training_attention_bound_is_the_serving_attentions():
    assert tta.MAX_N == tsa.MAX_N == 2048 + 4096


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_training_attention_checks_take_the_joint_domain(dtype):
    """Every 64-aligned n up to 6144 is in the kernels' domain, in both
    dtypes; n = 6208 and any n not a multiple of 64 are refused."""
    lens = torch.zeros(1, dtype=torch.int32)
    for n in range(64, tta.MAX_N + 1, 64):
        q = torch.zeros(1, n, 1, 64, dtype=dtype)
        tta._check_cuda_args(q, q, q, lens)
    for n in (tta.MAX_N + 64, 6144 - 32, 4160 + 1, 8192):
        q = torch.zeros(1, n, 1, 64, dtype=dtype)
        with pytest.raises(ValueError, match=r"n must be a multiple of 64 in \[64, 6144\]"):
            tta._check_cuda_args(q, q, q, lens)


def test_bf16_geometries_cover_every_joint_length():
    """`forward_geometry` and `backward_geometry` over every n to 6144: every
    row owned once by a warpgroup inside its block and inside the sample,
    the grid one block a 192 / 128 rows, shared memory independent of n, the
    tensor maps' strides 16-byte multiples and n a dimension of its own."""
    b, h = 9, 16
    for n in range(64, tta.MAX_N + 1, 64):
        for geo in (tta.forward_geometry(b, n, h), tta.backward_geometry(b, n, h)):
            assert geo["grid"] == (-(-n // geo["rows"]), h, b) == (len(geo["warpgroups"]), h, b)
            covered = np.zeros(n, np.int64)
            for block, groups in enumerate(geo["warpgroups"]):
                for start, rows in groups:
                    assert rows == geo["tile"] and start % geo["tile"] == 0
                    assert block * geo["rows"] <= start
                    assert start + rows <= min((block + 1) * geo["rows"], n)
                    covered[start:start + rows] += 1
            np.testing.assert_array_equal(covered, 1)
            assert geo["shared_bytes"] <= tta.SHARED_LIMIT
            tm = geo["tensor_map"]
            assert tm["dims"] == (64, h, n, b)
            assert tm["strides"] == (128, h * 128, n * h * 128)
            assert all(stride % 16 == 0 and stride < 2**40 for stride in tm["strides"])
        assert tta.forward_geometry(b, n, h)["shared_bytes"] == \
            tta.forward_geometry(b, 64, h)["shared_bytes"]
        assert tta.backward_geometry(b, n, h)["shared_bytes"] == \
            tta.backward_geometry(b, 64, h)["shared_bytes"]
    # the largest offset into a [b, n, h, 64] tensor fits 32 bits with room
    assert 9 * tta.MAX_N * 16 * 64 == 56_623_104 < 2**31


def test_fp32_geometries_cover_every_joint_length():
    """`forward_geometry_fp32` and `backward_geometry_fp32` over every n to
    6144: one 64-row block for each 64 rows, shared memory and blocks an SM
    independent of n."""
    b, h = 9, 16
    first = (tta.forward_geometry_fp32(b, 64, h), tta.backward_geometry_fp32(b, 64, h))
    for n in range(64, tta.MAX_N + 1, 64):
        fwd, bwd = tta.forward_geometry_fp32(b, n, h), tta.backward_geometry_fp32(b, n, h)
        for geo in (fwd, bwd):
            assert geo["grid"] == (n // 64, h, b)
            assert geo["blocks"] == [(r, 64) for r in range(0, n, 64)]
            assert geo["blocks_per_sm"] == 2
        assert fwd["shared_bytes"] == first[0]["shared_bytes"]
        assert (bwd["dq_shared_bytes"], bwd["dkv_shared_bytes"]) == \
            (first[1]["dq_shared_bytes"], first[1]["dkv_shared_bytes"])


@pytest.mark.parametrize("keep", [0.9, 0.5])
@pytest.mark.parametrize("seed", [0, 0x80000001, 0xFFFFFFFF])
def test_keep_mask_at_the_joint_corner_bit_identical_to_jax(seed, keep):
    """The keep bits of tiles whose rows and columns reach 6143 at n = 6144
    (the counter q * n + k up to 6144^2 - 1 = 3.8e7, unwrapped in 32 bits)
    against the JAX mask."""
    n = tta.MAX_N
    assert (n - 1) * n + n - 1 < 2**32
    for b_idx, h_idx, q0, k0, bq, bk in ((8, 15, n - 64, n - 64, 64, 64),
                                         (1, 3, n - 128, 0, 128, 64),
                                         (0, 0, 0, n - 128, 64, 128),
                                         (4, 9, 4096, 6016, 64, 128)):
        want = jta.dropout_keep_mask(jnp.uint32(seed), b_idx, h_idx, q0, k0, bq, bk, n, keep)
        got = tta.dropout_keep_mask(seed, b_idx, h_idx, q0, k0, bq, bk, n, keep)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
