"""PyTorch port, multi-device training (`parallel/mesh.py`, `parallel/shard.py`,
`Trainer(mesh=..., zero1=...)`) in real multi-process gloo groups on the CPU
(`tests/torch_mesh_workers.py`: the ranks import no JAX), against the JAX
``Trainer`` on a 2 x 1 mesh of the virtual CPU devices and against one
process of the port on the same weights and draws.

Tiny DiT (dim 64, depth 2, 2 heads x 32, ff_mult 2), fp32, a global batch
of 3 rows with unequal valid frames (16, 32, 9 of 32), padded to 4 on a
2-way data axis as the JAX trainer pads it, AdamW at lr 1e-3 with clipping
at 0.05 (every step clips). Tolerances, relative to each tensor's scale:

- against JAX: loss and gradient norm 1e-4, parameters and EMA 1e-5 (the
  one-device parity tests' bounds, `tests/test_torch_training.py`);
- against one process of the port: the same (the sums over ranks
  reassociate; at dropout 0.1 the kept bits are equal, so a wrong bit would
  move a parameter by the learning rate, 100x the bound);
- ZeRO-1 against the replicated layout and a resume against the run without
  a stop: bit for bit (the update is elementwise, only partitioned).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.compression.convert import backbone_params_to_torch
from eraxvif5tts_tpu.configs import ArchConfig as JArchConfig
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu.parallel.mesh import make_mesh as j_make_mesh
from eraxvif5tts_tpu.training import trainer as jtr
from eraxvif5tts_tpu_torch.compression.convert import state_dict_from_jax
from eraxvif5tts_tpu_torch.configs import ModelConfig
from eraxvif5tts_tpu_torch.parallel.mesh import pad_batch
from test_torch_models import close, redraw
from test_torch_training import _jax_draws
import torch_mesh_workers as wk

N = 32
LENS = [16, 32, 9]
SPEC = dict(learning_rate=1e-3, num_warmup_updates=1, total_updates=10, max_grad_norm=0.05)
JARCH = JArchConfig(**dataclasses.asdict(wk.ARCH))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"mel": rng.standard_normal((3, N, wk.MEL)).astype(np.float32),
            "text": np.asarray([[1, 2, 3, -1], [3, 1, -1, -1], [4, 4, 2, 5]], np.int32),
            "lens": np.asarray(LENS, np.int32)}


BATCHES = [_batch(10 + i) for i in range(4)]


def _draws_dict(rng, b):
    d = _jax_draws(rng, b, N)
    return {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}


@pytest.fixture(scope="module")
def weights():
    jcfm = JCFM(transformer=JDiT(arch=JARCH, text_num_embeds=wk.VOCAB, mel_dim=wk.MEL))
    params = redraw(jcfm.init_params(jax.random.key(0)), seed=1, std=0.05)
    sd = state_dict_from_jax(params, None, ModelConfig(arch=wk.ARCH))[0]
    return jcfm, params, sd


# the cases of one two-process group: (name, n_model, zero1, accumulate, dropout,
# [(batch index, draws)], save after)
JAX_KEYS = [jax.random.key(20 + i) for i in range(2)]
CASES = [
    ("dp", 1, False, 1, 0.0, [(i, _draws_dict(k, 4)) for i, k in enumerate(JAX_KEYS)], None),
    ("tp", 2, False, 1, 0.1, [(0, 5), (1, 6)], None),
    ("rep_acc", 1, False, 2, 0.1, [(i, 7 + i) for i in range(4)], None),
    ("z1_acc", 1, True, 2, 0.1, [(i, 7 + i) for i in range(4)], None),
    ("z1_save", 1, True, 1, 0.1, [(i, 11 + i) for i in range(3)], 1),
]


@pytest.fixture(scope="module")
def two_ranks(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks")
    outs = wk.spawn("train_cases", 2, str(tmp),
                    {"weights": weights[2], "batches": BATCHES, "cases": CASES})
    return tmp, outs


def _one_process(sd, dropout, steps, pad_to, accumulate=1, trainer_state=None):
    """The port on one process: the same steps on the padded global batch."""
    arch = dataclasses.replace(wk.ARCH, dropout=dropout)
    trainer, state = trainer_state or (None, None)
    if trainer is None:
        trainer = wk.make_trainer(sd, arch, accumulate=accumulate)
        state = trainer.init_state()
    metrics = wk.run_steps(trainer, state, [pad_batch(BATCHES[i], pad_to) for i, _ in steps],
                           [d for _, d in steps])
    return metrics, wk.consolidated(trainer, state)


def _same_run(got, want_metrics, want, rel=1e-5, what=""):
    for i, (m, w) in enumerate(zip(got["metrics"], want_metrics)):
        close(m["loss"], w["loss"], rel, f"{what} loss {i}")
        close(m["grad_norm"], w["grad_norm"], rel, f"{what} grad_norm {i}")
        assert m["applied"] == w["applied"]
    for kind in ("params", "ema_params"):
        for name, v in want[kind].items():
            close(got[kind][name], v, rel, f"{what} {kind} {name}")


def test_dp2_train_steps_match_the_jax_trainer_on_a_2x1_mesh(weights, two_ranks):
    """(b) Two DP-2 steps against the JAX `Trainer` on a 2 x 1 mesh (which
    pads the batch of 3 to 4 itself), on shared weights and draws."""
    jcfm, params, _ = weights
    mesh = j_make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    jt = jtr.Trainer(cfm=jcfm, optimizer=jtr.make_optimizer(**SPEC), mesh=mesh,
                     ema_update_after_step=0, ema_update_every=1)
    jstate = jt.init_state(jax.random.key(0), params=params)
    want = []
    for i, key in enumerate(JAX_KEYS):
        jstate, jm = jt.train_step(jstate, BATCHES[i], key)
        want.append({k: float(v) for k, v in jm.items()})
    for rank, out in enumerate(two_ranks[1]):
        got = out["dp"]
        for i, (m, w) in enumerate(zip(got["metrics"], want)):
            close(m["loss"], w["loss"], 1e-4, f"rank {rank} loss {i}")
            close(m["grad_norm"], w["grad_norm"], 1e-4, f"rank {rank} grad_norm {i}")
            assert m["applied"] == w["applied"] == 1.0
        for kind, tree in (("params", jstate.params), ("ema_params", jstate.ema_params)):
            for name, v in backbone_params_to_torch(jax.device_get(tree), "DiT", wk.ARCH.depth,
                                                    wk.ARCH.conv_layers,
                                                    with_prefix=False).items():
                close(got[kind][name], v, 1e-5, f"rank {rank} {kind} {name}")


def test_dp2_matches_one_process_on_a_padded_batch_of_3(weights, two_ranks):
    """(c) The global masked mean: the ranks hold 16 + 32 and 9 + 0 valid
    frames (a per-rank mean, then the ranks' average, would differ)."""
    steps = [s for s in CASES if s[0] == "dp"][0][5]
    want_metrics, want = _one_process(weights[2], 0.0, steps, 2)
    for out in two_ranks[1]:
        _same_run(out["dp"], want_metrics, want, what="dp")
    # the unequal frames do move a per-rank mean: the test can see it
    rows = np.asarray(LENS + [0])
    assert rows[:2].sum() != rows[2:].sum()


def test_tp2_matches_one_process_at_dropout_with_clipping(weights, two_ranks):
    """(d) TP 2 at dropout 0.1: one head and 64 feed-forward columns a rank,
    the attention's keep bits from the global head, the FF's from the global
    column, the norm over the shards; every step clips (norm > 0.05)."""
    steps = [s for s in CASES if s[0] == "tp"][0][5]
    want_metrics, want = _one_process(weights[2], 0.1, steps, 1)
    assert all(m["grad_norm"] > SPEC["max_grad_norm"] for m in want_metrics)
    for out in two_ranks[1]:
        _same_run(out["tp"], want_metrics, want, what="tp")
    # a control: the wrong dropout bits (seed moved) are far outside the bound
    moved = [(i, d + 100) for i, d in steps]
    wrong, _ = _one_process(weights[2], 0.1, moved, 1)
    assert abs(wrong[0]["loss"] - want_metrics[0]["loss"]) > 1e-3 * abs(want_metrics[0]["loss"])


def test_dp2_tp2_matches_one_process_at_dropout_with_clipping(weights, tmp_path):
    """(d) DP 2 x TP 2 on four ranks, the batch of 3 padded to 4."""
    steps = [(0, 5), (1, 6)]
    outs = wk.spawn("train_cases", 4, str(tmp_path),
                    {"weights": weights[2], "batches": BATCHES,
                     "cases": [("dptp", 2, False, 1, 0.1, steps, None)]})
    want_metrics, want = _one_process(weights[2], 0.1, steps, 2)
    for out in outs:
        _same_run(out["dptp"], want_metrics, want, what="dptp")


def test_zero1_matches_replicated_with_grad_accumulation(two_ranks):
    """(e) ZeRO-1 at DP 2, four micro-batches at k = 2 (two updates): loss,
    parameters and EMA bit for bit the replicated layout's; each rank holds
    half of the moments and the EMA."""
    for out in two_ranks[1]:
        rep, z1 = out["rep_acc"], out["z1_acc"]
        assert [m["applied"] for m in z1["metrics"]] == [0.0, 1.0, 0.0, 1.0]
        assert [m["loss"] for m in z1["metrics"]] == [m["loss"] for m in rep["metrics"]]
        for kind in ("params", "ema_params"):
            for name, v in rep[kind].items():
                assert np.array_equal(z1[kind][name], v), (kind, name)
        assert z1["state_numel"] < 0.51 * rep["state_numel"]


def test_zero1_resume_equals_the_run_without_a_stop(weights, two_ranks, tmp_path):
    """(f) A ZeRO-1 checkpoint of update 1 resumed in a fresh group gives
    updates 2-3 bit for bit; the same checkpoint loads into a one-device
    trainer, which continues within the DP bound."""
    tmp, outs = two_ranks
    path = str(tmp / "ckpt_z1_save" / "model_1")
    case = [s for s in CASES if s[0] == "z1_save"][0]
    rest = case[5][1:]
    resumed = wk.spawn("resume_case", 2, str(tmp_path),
                       {"weights": weights[2], "batches": BATCHES,
                        "resume": ("z1", 1, True, 1, 0.1, rest, path)})
    full = outs[0]["z1_save"]
    for out in resumed:
        assert out["step"] == 3
        assert [m["loss"] for m in out["metrics"]] == [m["loss"] for m in full["metrics"][1:]]
        for kind in ("params", "ema_params"):
            for name, v in full[kind].items():
                assert np.array_equal(out[kind][name], v), (kind, name)
    # the one-device format: a trainer off the mesh resumes it
    one = wk.make_trainer(weights[2], dataclasses.replace(wk.ARCH, dropout=0.1))
    state = one.load_checkpoint(path, one.init_state())
    assert state.step == 1
    metrics, got = _one_process(weights[2], 0.1, rest, 2, trainer_state=(one, state))
    _same_run({"metrics": metrics, **got}, full["metrics"][1:],
              {k: full[k] for k in ("params", "ema_params")}, what="one device")


def _phoneme_batch(i):
    """BATCHES[i] with phoneme ids (0 = pad): 6, 4 and 3 phonemes, so the
    ranks hold unequal counts (10 and 3 of the batch padded to 4)."""
    rng = np.random.default_rng(30 + i)
    ph = np.zeros((3, 6), np.int32)
    for row, count in enumerate((6, 4, 3)):  # no phoneme follows itself
        ph[row, :count] = rng.permutation(np.arange(1, wk.PRED_VOCAB))[:count]
    return {**BATCHES[i], "phoneme": ph}


# (name, n_model, dropout, focus updates, steps): the focus phase (the
# predictor alone), the full phase from the first update (both models), and
# the full phase with the DiT split over the model axis at dropout 0.1
CURRICULUM = [
    ("focus", 1, 0.0, 5, [(0, 40), (1, 41)]),
    ("full", 1, 0.0, 0, [(0, 42), (1, 43)]),
    ("full_tp", 2, 0.1, 0, [(0, 44), (1, 45)]),
]
CURRICULUM_METRICS = ("loss", "cfm_loss", "duration_loss", "duration_mae", "align_coverage",
                      "align_diagonal", "duration_weight", "grad_norm")


@pytest.mark.parametrize("case", [c[0] for c in CURRICULUM])
def test_curriculum_on_a_mesh_matches_one_process(weights, curriculum_ranks, case):
    """The duration-predictor curriculum on two ranks (DP 2, and TP 2 at
    dropout 0.1) against one process on the padded global batch: every
    metric (the duration loss, its MAE and the alignment quality global
    masked means) and the DiT's params and EMA within 1e-5 of scale, the
    predictor's weights within 1e-5, each rank's MAS durations the one
    process's rows bit for bit."""
    name, n_model, dropout, focus, steps = [c for c in CURRICULUM if c[0] == case][0]
    pad_to = 2 // n_model
    trainer = wk.make_curriculum_trainer(weights[2], _dur_weights(), dataclasses.replace(
        wk.ARCH, dropout=dropout), focus)
    state = trainer.init_state()
    want = wk.run_steps(trainer, state, [pad_batch(_phoneme_batch(i), pad_to) for i, _ in steps],
                        [d for _, d in steps])
    whole = wk.consolidated(trainer, state)
    if focus:
        assert trainer.alignment_manager.phase == 1
    for rank, out in enumerate(curriculum_ranks):
        got = out[name]
        for i, (m, w) in enumerate(zip(got["metrics"], want)):
            for key in CURRICULUM_METRICS:
                close(m[key], w[key], 1e-5, f"{case} rank {rank} step {i} {key}")
            assert m["applied"] == w["applied"] == 1.0
            rows = m["align_durations"].shape[0]
            np.testing.assert_array_equal(
                m["align_durations"].numpy(),
                w["align_durations"][got["row0"]:got["row0"] + rows].numpy())
        for kind in ("params", "ema_params"):
            for key, v in whole[kind].items():
                close(got[kind][key], v, 1e-5, f"{case} rank {rank} {kind} {key}")
        for key, v in state.dur_predictor.state_dict().items():
            close(got["dur"][key], v.detach().numpy(), 1e-5, f"{case} rank {rank} dur {key}")


def _dur_weights() -> dict:
    """The duration predictor's weights: the JAX init redrawn at std 0.2
    (as `tests/test_torch_training_cli.py` draws them)."""
    import jax.numpy as jnp

    from eraxvif5tts_tpu.models.duration import DurationPredictor as JDurationPredictor
    from eraxvif5tts_tpu_torch.models.duration import duration_state_dict_from_jax

    jdp = JDurationPredictor(vocab_size=wk.PRED_VOCAB, d_model=16, d_filter=16)
    ids = jnp.zeros((1, 8), jnp.int32)
    rng = np.random.default_rng(3)
    dparams = jax.tree.map(lambda p: (0.2 * rng.standard_normal(p.shape)).astype(np.float32),
                           jax.jit(jdp.init)(jax.random.key(0), ids, ids > 0)["params"])
    return duration_state_dict_from_jax(dparams)


@pytest.fixture(scope="module")
def curriculum_ranks(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("curriculum_ranks")
    return wk.spawn("curriculum_cases", 2, str(tmp),
                    {"weights": weights[2], "dur_weights": _dur_weights(),
                     "batches": [_phoneme_batch(i) for i in range(2)],
                     "curriculum": CURRICULUM})
