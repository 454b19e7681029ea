"""PyTorch port, host code: the port keeps its own copies of the JAX
package's pure host modules (configs, text, audio, the checkpoint key rules)
and imports nothing of that package. Each copied function is held to the
original on seeded inputs: equal results, exactly (the copies are the same
arithmetic; no tolerance is needed or given).
"""

import dataclasses
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from eraxvif5tts_tpu import configs as jconfigs
from eraxvif5tts_tpu.audio import io as jio
from eraxvif5tts_tpu.audio.resample import resample as j_resample
from eraxvif5tts_tpu.audio import silence as jsilence
from eraxvif5tts_tpu.compression import convert as jconvert
from eraxvif5tts_tpu.text import chunk as jchunk
from eraxvif5tts_tpu.text import pinyin as jpinyin
from eraxvif5tts_tpu.text import tokenizer as jtokenizer
from eraxvif5tts_tpu_torch import configs as tconfigs
from eraxvif5tts_tpu_torch.audio import io as tio
from eraxvif5tts_tpu_torch.audio.resample import resample as t_resample
from eraxvif5tts_tpu_torch.audio import silence as tsilence
from eraxvif5tts_tpu_torch.compression import convert as tconvert
from eraxvif5tts_tpu_torch.text import chunk as tchunk
from eraxvif5tts_tpu_torch.text import pinyin as tpinyin
from eraxvif5tts_tpu_torch.text import tokenizer as ttokenizer

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"
YAMLS = sorted(p.name for p in CONFIG_DIR.glob("*.yaml"))
SENTENCES = ("The keeper wrote one more line. ", "Tonight the sea was calm, and the lamp turned; ",
             "今天天气很好。", "Xin chào các bạn! ", "a", "supercalifragilisticexpialidocious" * 3 + " ",
             "What? No: never, ever. ", "它们，还有我们！")


def _texts(seed, count=12):
    rng = random.Random(seed)
    return ["".join(rng.choice(SENTENCES) for _ in range(rng.randint(1, 9)))
            for _ in range(count)]


def _speech_like(seed, seconds, sr):
    """Noise bursts between silences of 0.05 to 1.5 s: something to clip."""
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < seconds * sr:
        parts.append((0.3 * rng.standard_normal(int(rng.uniform(0.2, 2.5) * sr))
                      ).astype(np.float32))
        parts.append(np.zeros(int(rng.uniform(0.05, 1.5) * sr), np.float32))
    return np.concatenate([np.zeros(int(0.3 * sr), np.float32), *parts])


def _same_config(got, want):
    """Equal field by field; the two packages' dataclasses are distinct types."""
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]


@pytest.mark.parametrize("name", sorted(jconfigs.PRESETS))
def test_preset_equals_the_jax_packages(name):
    _same_config(tconfigs.PRESETS[name], jconfigs.PRESETS[name])
    assert sorted(tconfigs.PRESETS) == sorted(jconfigs.PRESETS)


@pytest.mark.parametrize("yaml_name", YAMLS)
def test_load_model_config_equals_the_jax_packages(yaml_name):
    path = str(CONFIG_DIR / yaml_name)
    _same_config(tconfigs.load_model_config(path), jconfigs.load_model_config(path))
    _same_config(tconfigs.load_yaml_config(path), jconfigs.load_yaml_config(path))


def _rules_cases():
    return {
        "dit": ("dit_rules", (3, 2), {}),
        "dit_qk_norm_long_skip": ("dit_rules", (2, 0), dict(qk_norm=True, long_skip=True)),
        "unett": ("unett_rules", (4, 0), {}),
        "unett_qk_norm_add": ("unett_rules", (4, 1), dict(qk_norm=True,
                                                          skip_connect_type="add")),
        "vocos": ("vocos_rules", (3,), {}),
    }


def _check_rules(name):
    fn, args, kwargs = _rules_cases()[name]
    got, want = getattr(tconvert, fn)(*args, **kwargs), getattr(jconvert, fn)(*args, **kwargs)
    assert [(r[0], r[1]) for r in got] == [(r[0], r[1]) for r in want]
    rng = np.random.default_rng(50)
    for (key, _, fwd, inv), (_, _, jfwd, jinv) in zip(got, want):
        shape = (5, 3, 7) if fwd(np.zeros((2, 3, 4))).shape == (4, 3, 2) else (5, 3)
        a = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(fwd(a), jfwd(a), err_msg=key)
        np.testing.assert_array_equal(inv(a), jinv(a), err_msg=key)
        np.testing.assert_array_equal(inv(fwd(a)), a, err_msg=key)


def _check_chunk_text(seed):
    for text in _texts(seed):
        for max_chars, hard_max in ((135, None), (40, None), (60, 25), (16, 16)):
            assert (tchunk.chunk_text(text, max_chars=max_chars, hard_max=hard_max)
                    == jchunk.chunk_text(text, max_chars=max_chars, hard_max=hard_max))


def _check_tokenizer(seed, tmp_path):
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text(" \na\nb\nc\n a \nd\n。\nni3\n", encoding="utf-8")
    got, want = ttokenizer.get_tokenizer(str(vocab_file)), jtokenizer.get_tokenizer(str(vocab_file))
    assert got == want and got[1] == 7
    assert ttokenizer.get_tokenizer(str(tmp_path)) == want  # a directory holding vocab.txt
    texts = _texts(seed, 5)
    vocab = {c: i for i, c in enumerate(sorted(set("".join(texts))))}
    for pad_to in (None, 1024):
        np.testing.assert_array_equal(ttokenizer.list_str_to_idx(texts, vocab, pad_to=pad_to),
                                      jtokenizer.list_str_to_idx(texts, vocab, pad_to=pad_to))
        np.testing.assert_array_equal(ttokenizer.list_str_to_bytes(texts, pad_to=pad_to),
                                      jtokenizer.list_str_to_bytes(texts, pad_to=pad_to))
    tokens = tpinyin.convert_char_to_pinyin(texts)
    assert tokens == jpinyin.convert_char_to_pinyin(texts)
    np.testing.assert_array_equal(ttokenizer.list_str_to_idx(tokens, vocab),
                                  jtokenizer.list_str_to_idx(tokens, vocab))
    with pytest.raises(ValueError, match="exceeds pad_to=3"):
        ttokenizer.list_str_to_idx(texts, vocab, pad_to=3)
    with pytest.raises(FileNotFoundError, match="not a vocab file/dir"):
        ttokenizer.get_tokenizer(str(tmp_path / "missing"))


def _check_resample(seed):
    wav = np.random.default_rng(seed).standard_normal((2, 4001)).astype(np.float32)
    for orig, target in ((16000, 24000), (44100, 24000), (24000, 24000), (48000, 24000)):
        got, want = t_resample(wav, orig, target), j_resample(wav, orig, target)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _check_silence(seed):
    sr = 8000
    for i, seconds in enumerate((3, 9, 20)):
        wav = _speech_like(seed + i, seconds, sr)
        for clip_short in (True, False):
            got = tsilence.clip_reference_audio(wav, sr, clip_short=clip_short)
            np.testing.assert_array_equal(
                got, jsilence.clip_reference_audio(wav, sr, clip_short=clip_short))
            assert 0 < len(got) <= len(wav) + int(0.05 * sr)
        assert (tsilence.detect_leading_silence(wav, sr)
                == jsilence.detect_leading_silence(wav, sr) > 0)
        np.testing.assert_array_equal(tsilence.remove_silence_edges(wav, sr),
                                      jsilence.remove_silence_edges(wav, sr))
        got, want = (m.split_on_silence(wav, sr, 100, -40.0) for m in (tsilence, jsilence))
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _check_wav_io(seed, tmp_path):
    rng = np.random.default_rng(seed)
    for channels in (1, 2):
        wav = np.clip(0.4 * rng.standard_normal((channels, 999)), -1.2, 1.2).astype(np.float32)
        tio.write_wav(str(tmp_path / "t.wav"), wav if channels > 1 else wav[0], 22050)
        jio.write_wav(str(tmp_path / "j.wav"), wav if channels > 1 else wav[0], 22050)
        assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
        (got, sr), (want, _) = tio.read_wav(str(tmp_path / "j.wav")), jio.read_wav(
            str(tmp_path / "t.wav"))
        assert sr == 22050 and got.shape == (channels, 999)
        np.testing.assert_array_equal(got, want)
        # 16-bit PCM of the clipped wave, written truncated at scale 32767 and
        # read back at scale 32768: within two quantisation steps
        assert np.abs(got - np.clip(wav, -1, 1)).max() <= 2.0 / 32768
    # an IEEE float32 file, which the stdlib `wave` module refuses
    data = rng.standard_normal(100).astype("<f4")
    header = (b"RIFF" + (36 + data.nbytes).to_bytes(4, "little") + b"WAVEfmt "
              + (16).to_bytes(4, "little") + (3).to_bytes(2, "little") + (1).to_bytes(2, "little")
              + (16000).to_bytes(4, "little") + (64000).to_bytes(4, "little")
              + (4).to_bytes(2, "little") + (32).to_bytes(2, "little") + b"data"
              + data.nbytes.to_bytes(4, "little"))
    (tmp_path / "f.wav").write_bytes(header + data.tobytes())
    (got, sr), (want, _) = tio.read_wav(str(tmp_path / "f.wav")), jio.read_wav(
        str(tmp_path / "f.wav"))
    assert sr == 16000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], data)


def _check_checkpoint_helpers(seed, tmp_path):
    rng = np.random.default_rng(seed)
    sd = {}
    for key in ("transformer.transformer_blocks.0.attn.to_q.weight",
                "transformer.transformer_blocks.4.ff.ff.2.bias",
                "transformer.text_embed.text_embed.weight", "transformer.text_embed.freqs_cis",
                "transformer.rotary_embed.inv_freq", "mel_spec.mel_stft.window"):
        sd["ema_model." + key] = rng.standard_normal((31, 4)).astype(np.float32)
        sd["model." + key] = rng.standard_normal((31, 4)).astype(np.float32)
    sd.update({"initted": np.array(True), "step": np.array(7)})
    for use_ema in (True, False):
        got = tconvert.normalize_reference_state_dict(sd, use_ema=use_ema)
        want = jconvert.normalize_reference_state_dict(sd, use_ema=use_ema)
        assert list(got) == list(want) and len(got) == 3
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])
    assert tconvert.infer_depth(sd) == jconvert.infer_depth(sd) == 5
    assert tconvert.infer_text_num_embeds(sd) == jconvert.infer_text_num_embeds(sd) == 30
    assert tconvert.infer_depth({"layers.3.1.g": 0}) == jconvert.infer_depth({"layers.3.1.g": 0})
    with pytest.raises(KeyError, match="text embedding table not found"):
        tconvert.infer_text_num_embeds({})
    # .pt files: flat, and a training checkpoint nesting the EMA dict
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    torch.save(tensors, tmp_path / "flat.pt")
    torch.save({"ema_model_state_dict": tensors, "update": 3}, tmp_path / "nested.pt")
    for name in ("flat.pt", "nested.pt"):
        got = tconvert.load_state_dict(str(tmp_path / name))
        want = jconvert.load_state_dict(str(tmp_path / name))
        assert list(got) == list(want) == list(sd)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


def _check_unstack(seed):
    """The unstacking adapters on numpy trees, against the JAX package's
    (which map with `jax.tree`): the per-block and the UNetT flat layouts."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def assert_same(got, want):
        assert sorted(got) == sorted(want)
        for key in got:
            if isinstance(got[key], dict):
                assert_same(got[key], want[key])
            else:
                np.testing.assert_array_equal(got[key], np.asarray(want[key]))

    dit = {"proj_out": {"kernel": leaf(4, 2)},
           "blocks": {"attn": {"to_q": {"kernel": leaf(3, 4, 4), "bias": leaf(3, 4)}},
                      "ff": {"project_in": {"kernel": leaf(3, 4, 8)}}}}
    assert_same(tconvert.unstack_block_params(dit), jconvert.unstack_block_params(dit))
    assert sorted(tconvert.unstack_block_params(dit)) == ["block_0", "block_1", "block_2",
                                                          "proj_out"]
    part = {"attn": {"to_q": {"kernel": leaf(2, 4, 4)}}, "attn_norm": {"g": leaf(2, 4)},
            "ff": {"project_in": {"bias": leaf(2, 8)}}, "ff_norm": {"g": leaf(2, 4)}}
    unett = {"norm_out": {"g": leaf(4)}, "down_blocks": part,
             "up_blocks": {**part, "skip_proj": {"kernel": leaf(2, 8, 4)}}}
    got = tconvert.unstack_unett_params(unett)
    assert_same(got, jconvert.unstack_unett_params(unett))
    assert "skip_proj_2" in got and "skip_proj_0" not in got and "attn_3" in got
    with pytest.raises(ValueError, match="no stacked 'blocks' subtree"):
        tconvert.unstack_block_params({"block_0": {}})
    with pytest.raises(ValueError, match="inconsistent leading depth axes"):
        tconvert.unstack_block_params({"blocks": {"a": leaf(2, 3), "b": leaf(3, 3)}})
    with pytest.raises(ValueError, match="no stacked UNetT subtrees"):
        tconvert.unstack_unett_params({"down_blocks": part})


def _check_remat_policy(seed):
    for policy in ("auto", "full", "dots", "attn"):
        for frames in (None, 1, 6 * 4096, 6 * 4096 + 1, 38400):
            assert (tconfigs.resolve_remat_policy(policy, frames)
                    == jconfigs.resolve_remat_policy(policy, frames))
    with pytest.raises(ValueError, match="unknown remat_policy 'some'"):
        tconfigs.resolve_remat_policy("some", 1)
    assert tconfigs.REMAT_DOTS_MAX_FRAMES == jconfigs.REMAT_DOTS_MAX_FRAMES


CHECKS = {
    **{f"rules_{name}": (lambda seed, tmp_path, name=name: _check_rules(name))
       for name in _rules_cases()},
    "chunk_text": lambda seed, tmp_path: _check_chunk_text(seed),
    "tokenizer_and_pinyin": _check_tokenizer,
    "resample": lambda seed, tmp_path: _check_resample(seed),
    "clip_reference_audio": lambda seed, tmp_path: _check_silence(seed),
    "wav_round_trip": _check_wav_io,
    "checkpoint_helpers": _check_checkpoint_helpers,
    "unstack_adapters": lambda seed, tmp_path: _check_unstack(seed),
    "remat_policy": lambda seed, tmp_path: _check_remat_policy(seed),
}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_copied_host_function_equals_the_original(name, tmp_path):
    CHECKS[name](60, tmp_path)
