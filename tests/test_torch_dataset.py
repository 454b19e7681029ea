"""PyTorch port, the data pipeline (`training/dataset.py`, `training/prepare.py`)
against the JAX package's.

Batches are held bit for bit: the sampler's packing and each epoch's order
(`random.Random(seed + epoch)`), and every array ``collate`` pads, phoneme
ids included (the live phoneme map grows alike in both). The host mel of
``numpy_log_mel`` and of an ``audio_path`` row: within 1e-5 of scale (the
same numpy arithmetic; the copies take their filterbank and Hann window
from the port's `ops/mel.py`). A dataset written by the port's
``prepare_csv_wavs`` loads through both packages' ``load_dataset`` to the same
rows, durations and mels. ``prefetch_batches`` passes a producer's error on.
"""

import json

import numpy as np
import pytest

from eraxvif5tts_tpu.training import dataset as J
from eraxvif5tts_tpu.training import prepare as JP
from eraxvif5tts_tpu_torch.audio.io import write_wav
from eraxvif5tts_tpu_torch.text.phoneme import PhonemeMap
from eraxvif5tts_tpu_torch.training import dataset as T
from eraxvif5tts_tpu_torch.training import prepare as TP

SR = 24000
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.")}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_samples,drop", [(0, False), (5, True)])
def test_sampler_batches_and_epoch_orders_equal_jax(seed, max_samples, drop):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(10, 900, 200).tolist()
    lengths[3] = 5000  # one sample over the budget: a batch of its own
    kw = dict(frames_threshold=2000, max_samples=max_samples, random_seed=seed,
              drop_residual=drop)
    want, got = J.DynamicBatchSampler(lengths, **kw), T.DynamicBatchSampler(lengths, **kw)
    assert got.batches == want.batches and len(got) == len(want)
    for epoch in range(4):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        assert list(got) == list(want)


def _samples(seed, n=5, n_mels=8, phonemes=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        frames = int(rng.integers(20, 300))
        text = "".join(rng.choice(list("abcde fghij.")) for _ in range(int(rng.integers(3, 90))))
        phon = " ".join(rng.choice(["a", "b", "ch", "dz", "e", "ng", "o"])
                        for _ in range(int(rng.integers(2, 40)))) if phonemes and i % 3 else None
        out.append((text, frames, rng.standard_normal((frames, n_mels)).astype(np.float32), phon))
    return out


def _as(module, rows):
    return [module.Sample(text=t, duration_frames=f, mel=m, phoneme=p) for t, f, m, p in rows]


@pytest.mark.parametrize("seed", [0, 1])
def test_collate_arrays_equal_jax_and_the_phoneme_map_grows_alike(seed):
    rows = _samples(seed)
    jmap, tmap = {}, PhonemeMap(max_index=200)
    for batch in (rows[:3], rows[2:]):  # the map carries over between batches
        want = J.collate(_as(J, batch), VOCAB, phoneme_map=jmap, pad_batch_to=4)
        got = T.collate(_as(T, batch), VOCAB, phoneme_map=tmap, pad_batch_to=4)
        assert sorted(got) == sorted(want) == ["lens", "mel", "phoneme", "text"]
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert dict(tmap) == jmap and len(tmap) > 3
    without = T.collate(_as(T, rows), VOCAB)
    assert "phoneme" not in without
    np.testing.assert_array_equal(without["text"], J.collate(_as(J, rows), VOCAB)["text"])


def _close(got, want, rel=1e-5):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("mel_spec_type", ["vocos", "bigvgan"])
def test_numpy_log_mel_matches_jax(mel_spec_type):
    wav = np.random.default_rng(0).standard_normal(SR // 2).astype(np.float32) * 0.1
    _close(T.numpy_log_mel(wav, mel_spec_type=mel_spec_type),
           J.numpy_log_mel(wav, mel_spec_type=mel_spec_type))
    with pytest.raises(ValueError, match="mel_spec_type"):
        T.numpy_log_mel(wav, mel_spec_type="hifigan")


def _wavs(tmp_path, n=4):
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rows = []
    rng = np.random.default_rng(1)
    for i in range(n):
        sr = 16000 if i == 1 else SR  # one file needs resampling
        wav = (0.1 * rng.standard_normal(int(sr * (0.6 + 0.3 * i)))).astype(np.float32)
        path = str(wav_dir / f"{i}.wav")
        write_wav(path, wav, sr)
        rows.append(f"{path}|{'hello world abc'[: 5 + 2 * i]}")
    short = str(wav_dir / "short.wav")
    write_wav(short, np.zeros(int(SR * 0.1), np.float32), SR)
    rows.append(f"{short}|too short")
    (tmp_path / "metadata.csv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    return tmp_path


def test_audio_path_mel_matches_jax(tmp_path):
    _wavs(tmp_path)
    rows = [{"audio_path": str(tmp_path / "wavs" / f"{i}.wav"), "text": "ab", "duration": 1.0}
            for i in range(4)] + [{"audio_path": str(tmp_path / "missing.wav"), "text": "x",
                                   "duration": 1.0}]
    want, got = J.CustomDataset(rows), T.CustomDataset(rows)
    for i in range(4):
        _close(got[i].mel, want[i].mel)
    assert got[4].mel is None and want[4].mel is None


def test_prepared_dataset_loads_alike_through_both_packages(tmp_path):
    pytest.importorskip("datasets")
    (tmp_path / "src").mkdir()
    src = _wavs(tmp_path / "src")
    summary = TP.prepare_csv_wavs(str(src), str(tmp_path / "prep" / "tiny_char"),
                                  use_pinyin=False)
    assert summary["samples"] == 4 and summary["skipped"] == 1
    lines = (tmp_path / "prep" / "tiny_char" / "vocab.txt").read_text("utf-8").splitlines()
    assert lines[0] == " " and lines == JP.build_vocab(
        [list("hello world abc"[: 5 + 2 * i]) for i in range(4)])
    durations = json.loads((tmp_path / "prep" / "tiny_char" / "duration.json").read_text())
    assert len(durations["duration"]) == 4
    want = J.load_dataset("tiny", "char", data_dir=str(tmp_path / "prep"))
    got = T.load_dataset("tiny", "char", data_dir=str(tmp_path / "prep"))
    assert len(got) == len(want) == 4 and got.durations == want.durations
    for i in range(4):
        g, w = got[i], want[i]
        assert (g.text, g.duration_frames, g.audio_path) == (w.text, w.duration_frames,
                                                             w.audio_path)
        _close(g.mel, w.mel)
    assert TP.main(["csv_wavs", str(src), str(tmp_path / "cli"), "--no-pinyin"])["samples"] == 4


def test_prefetch_passes_errors_on_and_keeps_order():
    assert list(T.prefetch_batches(iter(range(7)), depth=2)) == list(range(7))

    def failing():
        yield 1
        raise RuntimeError("bad row")

    it = T.prefetch_batches(failing())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="bad row"):
        next(it)
