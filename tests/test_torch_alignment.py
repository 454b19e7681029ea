"""PyTorch port, monotonic alignment search and the duration loss
(`training/alignment.py`) against the JAX package's.

- The three MAS algorithms on padded batches (phoneme and mel lengths from 0
  to the full width, more phonemes than frames included): durations equal
  exactly. The similarities lie on a 1/8 grid, so every prefix sum is exact
  in fp32 in any summation order (the JAX CPU cumsum is a parallel scan,
  torch's a sequential sum): the comparison holds the algorithms, ties
  included, not the rounding of two summation orders.
- ``build_similarity`` within 1e-6 of scale, ``make_mel_proj_matrix`` bit
  for bit, and ``duration_loss`` end to end (the frozen embedding, the mel
  projection, MAS, the predictor) on continuous inputs: durations equal, loss
  and MAE within 1e-5 relative. There no phoneme follows itself: two equal
  neighbouring ids have equal similarity rows, and the score of the boundary
  between them is the same wherever it falls, in exact arithmetic. The JAX
  package leaves that tie to its rounding (another backend could break it
  otherwise); the port's difference form keeps it exact (the first best
  column wins). A separate test holds such a batch to equal durations away
  from the tied boundary and to the mel length in every row.
- The two host state machines: the same sequences over 50 updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.models.duration import DurationPredictor as JDurationPredictor
from eraxvif5tts_tpu.training import alignment as J
from eraxvif5tts_tpu_torch.models.duration import DurationPredictor, duration_state_dict_from_jax
from eraxvif5tts_tpu_torch.training import alignment as T

ALGORITHMS = ("viterbi", "window", "progressive")


def _grid_batch(seed, b=4, nt=24, frames=96):
    rng = np.random.default_rng(seed)
    sim = (rng.integers(-24, 25, (b, nt, frames)) / 8).astype(np.float32)
    plens = rng.integers(1, nt + 1, b)
    mlens = rng.integers(1, frames + 1, b)
    plens[0], mlens[0] = nt, frames  # one sample at the full width
    plens[1], mlens[1] = nt, max(nt // 3, 1)  # more phonemes than frames
    if b > 3:
        plens[3] = mlens[3] = 0  # a padded row
    return sim, plens.astype(np.int32), mlens.astype(np.int32)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_durations_equal_jax_on_padded_batches(algorithm, seed):
    sim, plens, mlens = _grid_batch(seed)
    want = np.asarray(J.monotonic_alignment_durations(
        jnp.asarray(sim), jnp.asarray(plens), jnp.asarray(mlens), algorithm))
    got = T.monotonic_alignment_durations(torch.from_numpy(sim), torch.from_numpy(plens),
                                          torch.from_numpy(mlens), algorithm)
    np.testing.assert_array_equal(got.numpy(), want)
    # every valid row's durations sum to its mel length (viterbi and
    # progressive by construction; window ends its last phoneme on the last frame)
    for i in range(len(plens)):
        if 0 < plens[i] <= mlens[i]:
            assert got[i].sum().item() == mlens[i], (algorithm, i)


def test_unknown_algorithm_raises():
    sim, plens, mlens = _grid_batch(0)
    with pytest.raises(ValueError, match="unknown alignment algorithm"):
        T.monotonic_alignment_durations(torch.from_numpy(sim), torch.from_numpy(plens),
                                        torch.from_numpy(mlens), "dtw")


def _duration_setup(seed, vocab=20, d_model=16, b=3, nt=12, frames=80, n_mels=8,
                    repeat_at=None):
    rng = np.random.default_rng(seed)
    model = JDurationPredictor(vocab_size=vocab, d_model=d_model, d_filter=16)
    ids = np.zeros((b, nt), np.int32)
    plens = [nt, nt - 5, 3]
    for i, n in enumerate(plens):
        ids[i, 0] = rng.integers(1, vocab)
        for j in range(1, n):  # no phoneme follows itself
            ids[i, j] = (ids[i, j - 1] + rng.integers(1, vocab - 1) - 1) % (vocab - 1) + 1
    if repeat_at is not None:
        ids[0, repeat_at] = ids[0, repeat_at - 1]
    params = jax.jit(model.init)(jax.random.key(seed), jnp.asarray(ids), jnp.asarray(ids > 0))
    params = jax.tree.map(lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
                          .astype(np.float32), params["params"])
    mel = rng.standard_normal((b, frames, n_mels)).astype(np.float32)
    lens = np.array([frames, frames - 17, 40], np.int32)
    port = DurationPredictor(vocab, d_model, 16)
    port.load_state_dict(duration_state_dict_from_jax(params))
    return model, params, port, ids, mel, lens


def test_similarity_and_projection_match_jax():
    _, params, _, ids, mel, lens = _duration_setup(3)
    proj = T.make_mel_proj_matrix(mel.shape[-1], 16, seed=5)
    np.testing.assert_array_equal(proj, J.make_mel_proj_matrix(mel.shape[-1], 16, seed=5))
    table = params["embed"]["embedding"]
    plens = (ids > 0).sum(1)
    want = np.asarray(J.build_similarity(jnp.take(table, ids, axis=0), mel, proj, plens, lens))
    got = T.build_similarity(torch.from_numpy(table[ids]), torch.from_numpy(mel),
                             torch.from_numpy(proj), torch.from_numpy(plens),
                             torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got <= -1e8, want <= -1e8)
    valid = want > -1e8
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=1e-6 * np.abs(want[valid]).max())


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_duration_loss_matches_jax(algorithm):
    model, params, port, ids, mel, lens = _duration_setup(7)
    proj = T.make_mel_proj_matrix(mel.shape[-1], 16)
    table = params["embed"]["embedding"]
    want_loss, want_mae, want_durs = J.duration_loss(
        model, params, jnp.asarray(table), jnp.asarray(proj), jnp.asarray(ids),
        jnp.asarray(mel), jnp.asarray(lens), algorithm)
    loss, mae, durs = T.duration_loss(port, port, torch.from_numpy(proj),
                                      torch.from_numpy(ids).long(), torch.from_numpy(mel),
                                      torch.from_numpy(lens), algorithm)
    np.testing.assert_array_equal(durs.numpy(), np.asarray(want_durs))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(mae.item(), float(want_mae), rtol=1e-5)
    loss.backward()  # the predictor's gradient flows; the target is constant
    assert all(p.grad is not None for p in port.parameters())


def test_repeated_phoneme_tie_breaks_only_at_its_boundary():
    model, params, port, ids, mel, lens = _duration_setup(7, repeat_at=10)
    proj = T.make_mel_proj_matrix(mel.shape[-1], 16)
    table = params["embed"]["embedding"]
    for algorithm in ALGORITHMS:
        want = np.asarray(J.duration_loss(
            model, params, jnp.asarray(table), jnp.asarray(proj), jnp.asarray(ids),
            jnp.asarray(mel), jnp.asarray(lens), algorithm)[2])
        got = T.duration_loss(port, port, torch.from_numpy(proj),
                              torch.from_numpy(ids).long(), torch.from_numpy(mel),
                              torch.from_numpy(lens), algorithm)[2].numpy()
        np.testing.assert_array_equal(got[1:], want[1:])
        differ = np.flatnonzero(got[0] != want[0])
        assert set(differ) <= {9, 10}, (algorithm, differ)  # the tied pair alone
        np.testing.assert_array_equal(got.sum(1), want.sum(1))


def test_state_machines_match_jax_over_50_updates():
    jm, tm = J.AlignmentMethodManager(), T.AlignmentMethodManager()
    assert jm.set_steps_per_epoch(4) == tm.set_steps_per_epoch(4)
    js = J.DurationWeightScheduler(total_epochs=15, initial_weight=0.5, min_weight=0.1)
    ts = T.DurationWeightScheduler(total_epochs=15, initial_weight=0.5, min_weight=0.1)
    rng = np.random.default_rng(0)
    p2j = p2t = None
    for update in range(50):
        epoch = update // 4
        if jm.phase == 2 and p2j is None:
            p2j = update
        if tm.phase == 2 and p2t is None:
            p2t = update
        want = jm.update(update, 6, p2j, epoch)
        got = tm.update(update, 6, p2t, epoch)
        assert got == want, update
        if want[2]:
            p2j = p2t = update
            js.phase = ts.phase = 2
        cov, diag = rng.uniform(0.3, 1.0, 2)
        assert ts.step(update, cov, diag, epoch, 4) == js.step(update, cov, diag, epoch, 4)
        assert (ts.ema_cov, ts.ema_diag, ts.prev_weight) == (js.ema_cov, js.ema_diag,
                                                              js.prev_weight)
    assert tm.phase == 2 and tm.current_method == "viterbi"
