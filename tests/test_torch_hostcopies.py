"""PyTorch port, host code: the port keeps its own copies of the JAX
package's pure host modules (configs, text, audio with Griffin-Lim, the
checkpoint key rules, BigVGAN's filter, weight-norm fusion and
configurations, `utils.py`, the dataset preparation's pure functions)
and imports nothing of that package. Each copied function is held to the
original on seeded inputs: equal results, exactly (the copies are the same
arithmetic; no tolerance is needed or given).
"""

import dataclasses
import os
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
from eraxvif5tts_tpu.compression import pruner as jpruner
from eraxvif5tts_tpu.text import chunk as jchunk
from eraxvif5tts_tpu.text import phoneme as jphoneme
from eraxvif5tts_tpu.text import pinyin as jpinyin
from eraxvif5tts_tpu.text import tokenizer as jtokenizer
from eraxvif5tts_tpu_torch import configs as tconfigs
from eraxvif5tts_tpu_torch.audio import io as tio
from eraxvif5tts_tpu_torch.audio.resample import resample as t_resample
from eraxvif5tts_tpu_torch.audio import silence as tsilence
from eraxvif5tts_tpu_torch.compression import convert as tconvert
from eraxvif5tts_tpu_torch.compression import pruner as tpruner
from eraxvif5tts_tpu_torch.text import chunk as tchunk
from eraxvif5tts_tpu_torch.text import phoneme as tphoneme
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
        "mmdit": ("mmdit_rules", (3,), {}),
        "mmdit_qk_norm": ("mmdit_rules", (2,), dict(qk_norm=True)),
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


def _check_phoneme(seed):
    for text in _texts(seed, 6):
        assert tphoneme.phonemize(text) == jphoneme.phonemize(text)
        for grow in (True, False):
            got, want = tphoneme.PhonemeMap({"a": 1}), jphoneme.PhonemeMap({"a": 1})
            assert (tphoneme.phoneme_to_indices(tphoneme.phonemize(text), got, grow=grow)
                    == jphoneme.phoneme_to_indices(jphoneme.phonemize(text), want, grow=grow))
            assert dict(got) == dict(want)
            assert (tphoneme.text_to_phoneme_indices(text, dict(got))
                    == jphoneme.text_to_phoneme_indices(text, dict(want)))
    with pytest.raises(ValueError, match="only holds ids <= 2"):
        tphoneme.phoneme_to_indices(list("xyz"), tphoneme.PhonemeMap({"a": 1}, max_index=2))


def _check_pruner(seed):
    """The numpy core of the pruner on a synthetic 8-block checkpoint (one
    block constant, one the others' scale x 3): scores, the selection in
    both modes, the re-indexing, the position prior and the embedding
    growth, equal to the original's."""
    rng = np.random.default_rng(seed)
    sd = {"transformer.text_embed.text_embed.weight": rng.standard_normal((9, 4)),
          "transformer.proj_out.weight": rng.standard_normal((3, 4))}
    for i in range(8):
        for name, shape in (("attn.to_q.weight", (16, 8)), ("ff.ff.2.bias", (8,)),
                            ("attn_norm.linear.bias", (48,))):
            scale = 3.0 if i == 5 else 1.0
            sd[f"transformer.transformer_blocks.{i}.{name}"] = (
                np.full(shape, 0.5) if i == 2 else scale * rng.standard_normal(shape))
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    scores, fallback = tpruner.block_importance_scores(sd)
    assert (scores, fallback) == jpruner.block_importance_scores(sd) and not fallback
    for target, manual in ((6, None), (4, None), (3, None), (5, [0, 2, 3, 6, 7])):
        keep = tpruner.select_blocks_to_keep(scores, 8, target, manual)
        assert keep == jpruner.select_blocks_to_keep(scores, 8, target, manual)
        got, want = tpruner.prune_state_dict(sd, keep), jpruner.prune_state_dict(sd, keep)
        assert list(got) == list(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])
    flat = {k: np.zeros_like(v) for k, v in sd.items()}
    assert tpruner.block_importance_scores(flat) == jpruner.block_importance_scores(flat)
    for rows in (5, 20):
        got = tpruner.expand_text_embedding(sd, rows, seed=seed)
        want = jpruner.expand_text_embedding(sd, rows, seed=seed)
        assert list(got) == list(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


def _check_wave_stream(seed):
    from eraxvif5tts_tpu.serving import wave_stream as jws
    from eraxvif5tts_tpu_torch.serving import wave_stream as tws

    for sr, bits, channels in ((24000, 16, 1), (16000, 16, 2), (44100, 32, 1)):
        assert (tws.create_wave_header(sr, bits, channels)
                == jws.create_wave_header(sr, bits, channels))
    wave = np.random.default_rng(seed).standard_normal(999) * 0.7
    wave[:3] = (1.5, -2.0, 0.0)
    assert tws.float_to_int16_bytes(wave) == jws.float_to_int16_bytes(wave)


def _check_socket_client(seed):
    """Both clients against one server thread that streams float32 frames in
    odd-sized pieces and ends with END: the same waveform back."""
    import asyncio
    import socket
    import threading

    from eraxvif5tts_tpu.serving import socket_client as jsc
    from eraxvif5tts_tpu_torch.serving import socket_client as tsc

    payload = np.random.default_rng(seed).standard_normal(3001).astype(np.float32).tobytes()
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen()
    port = srv.getsockname()[1]

    def serve(n):
        for _ in range(n):
            conn, _ = srv.accept()
            with conn:
                assert conn.recv(1024) == "xin chào".encode("utf-8")
                for i in range(0, len(payload), 1001):
                    conn.sendall(payload[i: i + 1001])
                conn.sendall(b"END")

    thread = threading.Thread(target=serve, args=(2,))
    thread.start()
    try:
        got = asyncio.run(tsc.listen_to_f5tts("xin chào", "127.0.0.1", port, play=False))
        want = asyncio.run(jsc.listen_to_f5tts("xin chào", "127.0.0.1", port, play=False))
    finally:
        thread.join(30)
        srv.close()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], np.frombuffer(payload, np.float32))
    assert got[1] is not None and got[1] >= 0


def _check_parse_multipart(seed):
    from eraxvif5tts_tpu.serving.http_server import _parse_multipart as j_parse
    from eraxvif5tts_tpu_torch.serving.http_server import _parse_multipart as t_parse

    rng = np.random.default_rng(seed)
    blob = rng.integers(0, 256, 777, dtype=np.uint8).tobytes()
    for boundary in ("x123", '"quoted-b"', "----WebKitFormBoundary7MA4YWxk"):
        b = boundary.strip('"')
        body = (f'--{b}\r\ncontent-disposition: form-data; name="reference_id"\r\n\r\n'
                f'voice_1\r\n--{b}\r\ncontent-disposition: form-data; name="ref_text"\r\n'
                f'\r\nxin chào các bạn\r\n--{b}\r\ncontent-disposition: form-data; '
                f'name="file"; filename="a.wav"\r\ncontent-type: audio/wav\r\n\r\n'
                ).encode() + blob + f"\r\n--{b}\r\nno-headers-here\r\n--{b}--\r\n".encode()
        ctype = f"multipart/form-data; boundary={boundary}"
        assert t_parse(ctype, body) == j_parse(ctype, body)
    with pytest.raises(ValueError) as got:
        t_parse("multipart/form-data", b"")
    with pytest.raises(ValueError) as want:
        j_parse("multipart/form-data", b"")
    assert str(got.value) == str(want.value)


def _check_parse_spans(seed):
    from eraxvif5tts_tpu.infer.speech_edit import parse_spans as j_parse
    from eraxvif5tts_tpu_torch.infer.speech_edit import parse_spans as t_parse

    rng = np.random.default_rng(seed)
    for _ in range(20):
        cuts = np.round(np.sort(rng.uniform(0, 30, 2 * rng.integers(1, 5))), 3)
        text = ",".join(f"{a}:{b}" for a, b in zip(cuts[::2], cuts[1::2]))
        assert t_parse(text) == j_parse(text)


def _check_split_voice_chunks(seed):
    from eraxvif5tts_tpu.infer.infer_cli import split_voice_chunks as j_split
    from eraxvif5tts_tpu_torch.infer.infer_cli import split_voice_chunks as t_split

    rng = random.Random(seed)
    for text in _texts(seed):
        words = text.split(" ")
        for _ in range(3):
            words.insert(rng.randrange(len(words) + 1), rng.choice(("[main]", "[town]",
                                                                     "[a_1]", "[]", "[x y]")))
        tagged = " ".join(words)
        assert t_split(tagged) == j_split(tagged)


def _check_merge_config(seed, tmp_path):
    from eraxvif5tts_tpu.infer import infer_cli as jcli
    from eraxvif5tts_tpu_torch.infer import infer_cli as tcli

    toml = tmp_path / "c.toml"
    toml.write_text('model = "E2TTS_Base"\nnfe_step = 16\nspeed = 0.9\nremove_silence = true\n'
                    '[voices.town]\nref_audio = "t.wav"\nref_text = ""\n')
    rng = random.Random(seed)
    flags = [["--nfe_step", "8"], ["--speed", "1.2"], ["-t", "hi"], ["--save_chunk"],
             ["--remove_silence"], ["--device", "cpu"], ["--seed", "3"], ["-o", "out"],
             ["--vocoder_name", "vocos"], ["--fix_duration", "2.5"]]
    for _ in range(12):
        argv = (["-c", str(toml)] if rng.random() < 0.7 else []) + sum(
            rng.sample(flags, rng.randint(0, len(flags))), [])
        assert tcli.merge_config(tcli.parse_args(argv)) == jcli.merge_config(
            jcli.parse_args(argv))


def _check_speechtypes(seed):
    from eraxvif5tts_tpu.infer.infer_gradio import parse_speechtypes_text as j_parse
    from eraxvif5tts_tpu_torch.infer.infer_gradio import parse_speechtypes_text as t_parse

    rng = random.Random(seed)
    for text in _texts(seed):
        words = text.split(" ")
        for _ in range(3):
            words.insert(rng.randrange(len(words) + 1),
                         rng.choice(("{Regular}", "{Whisper}", "{}", "{ Sad }", "{a}{b}")))
        tagged = " ".join(words)
        assert t_parse(tagged) == j_parse(tagged)


def _check_chat_session(seed):
    from eraxvif5tts_tpu.infer.infer_gradio import ChatSession as JChat
    from eraxvif5tts_tpu_torch.infer.infer_gradio import ChatSession as TChat

    rng = random.Random(seed)

    def chat(messages):
        return f"turn {len(messages)}: {messages[-1]['content'][::-1]}"

    sessions = (TChat(), JChat())
    for _ in range(10):
        op = rng.choice(("say", "say", "say", "blank", "clear", "prompt"))
        text = rng.choice(_texts(seed, 3))
        for s in sessions:
            if op == "say":
                s.process_input(text, chat)
            elif op == "blank":
                assert s.process_input("   ", chat) is None
            elif op == "clear":
                s.clear()
            else:
                s.set_system_prompt(text)
        assert sessions[0].history == sessions[1].history
        assert sessions[0].messages == sessions[1].messages
        assert sessions[0].system_prompt == sessions[1].system_prompt


def _check_bigvgan_host_code(seed):
    """The BigVGAN pieces copied from `eraxvif5tts_tpu/models/bigvgan.py`:
    the kaiser-sinc filter, the weight-norm fusion (every layout) and the
    configurations; and `TEXT_MAX_POS` of the MMDiT."""
    from eraxvif5tts_tpu.models import bigvgan as jb
    from eraxvif5tts_tpu.models import mmdit as jmmdit
    from eraxvif5tts_tpu_torch.models import bigvgan as tb
    from eraxvif5tts_tpu_torch.models import mmdit as tmmdit

    rng = np.random.default_rng(seed)
    for _ in range(10):
        args = (float(rng.uniform(0, 0.5)), float(rng.uniform(0.05, 0.6)),
                int(rng.integers(2, 32)))
        np.testing.assert_array_equal(tb.kaiser_sinc_filter1d(*args),
                                      jb.kaiser_sinc_filter1d(*args))
    v = rng.standard_normal((6, 4, 3)).astype(np.float32)
    g = rng.uniform(0.5, 2.0, (6, 1, 1)).astype(np.float32)
    for sd in ({"c.weight": v}, {"c.weight_g": g, "c.weight_v": v},
               {"c.parametrizations.weight.original0": g,
                "c.parametrizations.weight.original1": v}, {"c.bias": g}):
        got, want = tconvert._fuse_weight_norm(sd, "c"), jb._fuse_weight_norm(sd, "c")
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    for got, want in ((tb.BigVGANConfig(), jb.BigVGANConfig()),
                      (tb.BIGVGAN_BASE_24KHZ, jb.BIGVGAN_BASE_24KHZ)):
        _same_config(got, want)
    assert tmmdit.TEXT_MAX_POS == jmmdit.TEXT_MAX_POS


def _check_client_html(seed):
    root = Path(__file__).resolve().parent.parent
    got = (root / "eraxvif5tts_tpu_torch" / "serving" / "client.html").read_bytes()
    assert got == (root / "eraxvif5tts_tpu" / "serving" / "client.html").read_bytes()
    from eraxvif5tts_tpu_torch.serving import http_server

    assert http_server._CLIENT_HTML.encode("utf-8") == got



def _check_griffin_lim(seed):
    from eraxvif5tts_tpu.audio.griffin_lim import griffin_lim_mel as j_gl
    from eraxvif5tts_tpu.ops.stft import hann_window as j_hann
    from eraxvif5tts_tpu_torch.audio.griffin_lim import griffin_lim_mel as t_gl
    from eraxvif5tts_tpu_torch.ops.mel import hann_window as t_hann

    for n in (1024, 800, 7):
        np.testing.assert_array_equal(t_hann(n), j_hann(n))
    rng = np.random.default_rng(seed)
    log_mel = (rng.standard_normal((100, 24)) - 3.0).astype(np.float32)
    np.testing.assert_array_equal(t_gl(log_mel, n_iter=4, seed=seed),
                                  j_gl(log_mel, n_iter=4, seed=seed))
    np.testing.assert_array_equal(t_gl(log_mel[:80], n_iter=2, win_length=800, variant="slaney"),
                                  j_gl(log_mel[:80], n_iter=2, win_length=800, variant="slaney"))


def _check_utils(seed):
    from eraxvif5tts_tpu import utils as jutils
    from eraxvif5tts_tpu_torch import utils as tutils

    draws = []
    for mod in (jutils, tutils):
        mod.seed_everything(seed)
        draws.append((random.random(), np.random.rand(), torch.rand(3).tolist()))
    assert draws[0] == draws[1]
    for v, d in ((None, 3), (0, 3), ("", "x")):
        assert tutils.exists(v) == jutils.exists(v)
        assert tutils.default(v, d) == jutils.default(v, d)


def _check_prepare(seed, tmp_path):
    from eraxvif5tts_tpu.training import prepare as jprep
    from eraxvif5tts_tpu_torch.training import prepare as tprep

    for text in _texts(seed) + ["ab" * 20, "xxxx" * 8, ""]:
        for length, tol in ((2, 10), (4, 3), (1, 2)):
            assert tprep.repetition_found(text, length, tol) == jprep.repetition_found(
                text, length, tol)
    texts = [list(t) for t in _texts(seed)] + ["cab", [" ", "b"]]
    assert tprep.build_vocab(texts) == jprep.build_vocab(texts)
    path = str(tmp_path / "d.wav")
    tio.write_wav(path, np.zeros(12345, np.float32), 22050)
    assert tprep.wav_duration_seconds(path) == jprep.wav_duration_seconds(path)
    meta = tmp_path / "meta.csv"
    meta.write_text("a.wav|spk|xin chao.\nb.wav|x\nc.wav|spk|mot hai ba..\n"
                    + "".join(f"{k}.wav|{t}\n" for k, t in enumerate(_texts(seed, 4))),
                    encoding="utf-8")
    want = jprep.prepare_phonemes(str(meta), str(tmp_path / "j.jsonl"), normalize_fn=str.lower,
                                  shuffle=True, seed=seed)
    got = tprep.prepare_phonemes(str(meta), str(tmp_path / "t.jsonl"), normalize_fn=str.lower,
                                 shuffle=True, seed=seed)
    assert (got["written"], got["skipped"]) == (want["written"], want["skipped"])
    assert (tmp_path / "t.jsonl").read_text("utf-8") == (tmp_path / "j.jsonl").read_text("utf-8")


def _check_utils_eval(seed, tmp_path):
    from eraxvif5tts_tpu.eval import utils_eval as jue
    from eraxvif5tts_tpu_torch.eval import utils_eval as tue

    texts = _texts(seed, 8)
    meta = tmp_path / "meta.lst"
    meta.write_text("".join(
        f"u{i}|{a.strip()}|p{i % 3}.wav|{b.strip()}" + (f"|g{i}.wav" if i % 2 else "") + "\n"
        for i, (a, b) in enumerate(zip(texts, texts[1:]))), encoding="utf-8")
    rows = tue.get_seedtts_testset_metainfo(str(meta))
    assert rows == jue.get_seedtts_testset_metainfo(str(meta))
    ls = tmp_path / "ls.lst"
    ls.write_text("1089-134686-0001\t3.0\tref a\t1089-134686-0005\t4.0\tgen a\n"
                  "1188-133604-0002\t2.5\tref b\t1188-133604-0007\t5.0\tgen b\n")
    assert tue.get_librispeech_test(str(ls), "root") == jue.get_librispeech_test(str(ls), "root")

    # the prompt bucketing over seeded clip lengths, a fake frontend and reader
    rng = np.random.default_rng(seed)
    lengths = {f"p{k}.wav": int(rng.integers(24000, 24000 * 6)) for k in range(3)}
    lengths.update({f"g{i}.wav": int(rng.integers(24000, 24000 * 9)) for i in range(8)})

    def load_wav(path):
        n = lengths[os.path.basename(path)]
        return np.linspace(-0.5, 0.5, n, dtype=np.float32)[None].repeat(1 + n % 2, 0), 24000

    def mel_fn(wav):
        return np.full((len(wav) // 256, 4), float(len(wav) % 7), np.float32)

    for kw in (dict(), dict(use_truth_duration=True, speed=0.8, num_buckets=7, batch_frames=3000),
               dict(min_seconds=1.0, max_seconds=5.0, num_buckets=3, batch_frames=900)):
        got = tue.get_inference_prompt(rows, mel_fn, load_wav, list, **kw)
        want = jue.get_inference_prompt(rows, mel_fn, load_wav, list, **kw)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert type(g).__name__ == type(w).__name__ == "PromptBatch"
            assert (g.utts, g.final_texts, g.bucket_frames) == (w.utts, w.final_texts,
                                                               w.bucket_frames)
            for name in ("ref_mels", "ref_mel_lens", "total_mel_lens"):
                a, b = getattr(g, name), getattr(w, name)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)

    pairs = [(t, u) for t, u in zip(texts + ["你好，世界。", "「引用」：测试…！"],
                                   texts[::-1] + ["你好世间", "引用测试"])]
    for truth, hypo in pairs:
        for lang in ("en", "zh", "vi"):
            assert tue.normalize_text(truth, lang) == jue.normalize_text(truth, lang)
            assert tue.word_error_rate(truth, hypo, lang) == jue.word_error_rate(truth, hypo, lang)
        assert tue.edit_distance(list(truth), list(hypo)) == jue.edit_distance(list(truth),
                                                                                list(hypo))
    a, b = rng.standard_normal(16), rng.standard_normal(16)
    assert tue.cosine_similarity(a, b) == jue.cosine_similarity(a, b)

    def asr(path):
        return texts[int(path[1:]) % len(texts)][::-1]

    wer_pairs = [(f"w{i}", t) for i, t in enumerate(texts)]
    sim_pairs = [(f"gen{i}", f"prompt{i % 3}") for i in range(9)]

    def embed(path):
        return np.random.default_rng(sum(map(ord, path))).standard_normal(8)

    for workers in (1, 4):
        assert (tue.run_asr_wer(wer_pairs, "en", asr, workers)
                == jue.run_asr_wer(wer_pairs, "en", asr, workers))
        assert tue.run_sim(sim_pairs, embed, workers) == jue.run_sim(sim_pairs, embed, workers)
        assert (tue._ordered_pool_map(len, texts, workers)
                == jue._ordered_pool_map(len, texts, workers))


def _check_rtf_meter(seed, monkeypatch):
    """`profiling.RTFMeter` under one fake clock: the same summary."""
    import time

    from eraxvif5tts_tpu import profiling as jprof
    from eraxvif5tts_tpu_torch import profiling as tprof

    rng = np.random.default_rng(seed)
    ticks = np.cumsum(rng.uniform(0.01, 0.9, 64)).tolist()
    chunks = rng.integers(100, 48000, 64).tolist()
    summaries = []
    for mod in (jprof, tprof):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        meter = mod.RTFMeter(sample_rate=24000)
        for request in range(5):
            meter.start_request()
            for k in range(1 + request % 3):
                meter.record_chunk(chunks[4 * request + k])
            meter.end_request()
        summaries.append((meter.summary(), meter.rtf, meter.total_audio_samples))
    monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert tprof.RTFMeter().summary() == jprof.RTFMeter().summary()


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
    "phoneme": lambda seed, tmp_path: _check_phoneme(seed),
    "pruner": lambda seed, tmp_path: _check_pruner(seed),
    "wave_stream": lambda seed, tmp_path: _check_wave_stream(seed),
    "socket_client": lambda seed, tmp_path: _check_socket_client(seed),
    "parse_multipart": lambda seed, tmp_path: _check_parse_multipart(seed),
    "parse_spans": lambda seed, tmp_path: _check_parse_spans(seed),
    "split_voice_chunks": lambda seed, tmp_path: _check_split_voice_chunks(seed),
    "merge_config": _check_merge_config,
    "parse_speechtypes_text": lambda seed, tmp_path: _check_speechtypes(seed),
    "chat_session": lambda seed, tmp_path: _check_chat_session(seed),
    "client_html": lambda seed, tmp_path: _check_client_html(seed),
    "bigvgan_host_code": lambda seed, tmp_path: _check_bigvgan_host_code(seed),
    "griffin_lim": lambda seed, tmp_path: _check_griffin_lim(seed),
    "utils": lambda seed, tmp_path: _check_utils(seed),
    "prepare": _check_prepare,
    "utils_eval": _check_utils_eval,
}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_copied_host_function_equals_the_original(name, tmp_path):
    CHECKS[name](60, tmp_path)


def test_copied_rtf_meter_equals_the_original(monkeypatch):
    _check_rtf_meter(60, monkeypatch)


def _py_modules(package: str) -> set[str]:
    root = Path(__file__).resolve().parent.parent / package
    return {p.relative_to(root).as_posix() for p in root.rglob("*.py")}


def test_every_jax_module_has_a_port_counterpart():
    """Every `.py` file of the JAX package has one of the same name and place
    in the port: the port does all that the JAX package does, module by
    module (the port's extra modules, its kernels' loader and tools, are
    its own)."""
    jax_modules = _py_modules("eraxvif5tts_tpu")
    assert len(jax_modules) > 60
    assert sorted(jax_modules - _py_modules("eraxvif5tts_tpu_torch")) == []
