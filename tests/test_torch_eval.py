"""PyTorch port, the eval harness: the ECAPA-TDNN head, batched test-set
inference, the infill battery, the scorers and their CLI, and `profiling`,
against the JAX package on the same inputs (weights and clips made from a
seed with numpy, the sampler noise the JAX draw handed in).

Tolerances: ECAPA embeddings within 1e-5 of their scale (fp32 convolutions
summed in other orders), and over the bundled clip through each package's
own log-mel frontend within 1e-4 (the frontends differ near the log floor);
the eval wavs within 1 PCM LSB and the mels within 1e-4 (fp32, two Euler
steps of a tiny DiT, as `tests/test_torch_slice.py`); the infill mels within
1e-4 and each cell's metrics within one unit of their 4-decimal rounding;
the infill arm in bf16 (fp32 parameters, the feed-forward on kernel 2's
plain version) within 1e-2 of the mel's scale (measured 5.3e-3: bf16
activations rounded in other places) and its cells within 1e-3; the
scorers' summaries and jsonl lines equal.
"""

import json
import os
import shutil
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.eval import __main__ as jmain
from eraxvif5tts_tpu.eval import ecapa_tdnn as jecapa
from eraxvif5tts_tpu.eval import eval_infer_batch as jbatch
from eraxvif5tts_tpu.eval import infill as jinfill
from eraxvif5tts_tpu.eval import scorers as jscorers
from eraxvif5tts_tpu.eval import utils_eval as jue
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu_torch import profiling
from eraxvif5tts_tpu_torch.audio.io import read_wav, write_wav
from eraxvif5tts_tpu_torch.compression.convert import (
    backbone_state_dict_to_reference,
    state_dict_from_jax,
)
from eraxvif5tts_tpu_torch.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu_torch.eval import __main__ as tmain
from eraxvif5tts_tpu_torch.eval import ecapa_tdnn as tecapa
from eraxvif5tts_tpu_torch.eval import eval_infer_batch as tbatch
from eraxvif5tts_tpu_torch.eval import infill as tinfill
from eraxvif5tts_tpu_torch.eval import scorers as tscorers
from eraxvif5tts_tpu_torch.eval import utils_eval as tue
from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.models.cfm import CFM
from eraxvif5tts_tpu_torch.models.dit import DiT
from test_torch_models import MEL, redraw
from test_torch_porcelain import tiny_wrappers
from test_torch_slice import CFG, SR
from test_torch_slice import VOCAB as VOCAB_MAP

REPO_ROOT = Path(__file__).resolve().parent.parent
CLIP = REPO_ROOT / "eraxvif5tts_tpu" / "infer" / "examples" / "basic" / "basic_ref_en.wav"
PCM_LSB = 1
MEL_TOL = 1e-4
BF16_MEL_TOL = 1e-2
BF16_CELL_TOL = 1e-3
ECAPA_TOL = 1e-5
ECAPA_CLIP_TOL = 1e-4


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


# ---- ECAPA-TDNN -------------------------------------------------------------


def _unispeech_state_dict(seed=3, feat_dim=80, channels=64, emb_dim=32) -> dict:
    """The port's head in the UniSpeech layout with every weight and every
    BatchNorm statistic drawn from a seeded numpy generator (the BatchNorm
    gains near 1, so that no block is attenuated out of the embedding)."""
    rng = np.random.default_rng(seed)
    sd = tecapa.ECAPA_TDNN(feat_dim, channels, emb_dim).state_dict()
    out = {}
    for key, value in sd.items():
        draw = rng.standard_normal(value.shape).astype(np.float32)
        if key.endswith("num_batches_tracked"):
            out[key] = value
        elif key.endswith("running_var"):
            out[key] = torch.from_numpy(0.5 + rng.random(value.shape).astype(np.float32))
        elif key.endswith(".weight") and key[:-len("weight")] + "running_mean" in sd:
            out[key] = torch.from_numpy(1.0 + 0.1 * draw)
        else:
            out[key] = torch.from_numpy(0.1 * draw)
    return out


def test_ecapa_random_params_are_the_jax_draws_and_embed_alike():
    """JAX ``init_random_params`` -> ``ecapa_state_dict_from_jax`` gives the
    port's own ``init_random_params`` on the same generator bit for bit, and
    the port's module embeds as ``ecapa_embed`` does."""
    jparams = jecapa.init_random_params(np.random.default_rng(0), feat_dim=80, channels=64,
                                        emb_dim=32)
    sd = tecapa.ecapa_state_dict_from_jax(jparams)
    own = tecapa.init_random_params(np.random.default_rng(0), feat_dim=80, channels=64,
                                    emb_dim=32)
    assert sorted(sd) == sorted(own)
    for key in sd:
        assert sd[key].dtype == own[key].dtype and torch.equal(sd[key], own[key]), key
    feats = np.random.default_rng(1).standard_normal((2, 50, 80)).astype(np.float32)
    want = np.asarray(jax.jit(jecapa.ecapa_embed)(jparams, jnp.asarray(feats)))
    with torch.no_grad():
        got = tecapa.ecapa_from_state_dict(sd, "cpu")(torch.from_numpy(feats)).numpy()
    assert got.shape == (2, 32)
    assert rel_err(got, want) <= ECAPA_TOL


def test_ecapa_unispeech_state_dict_round_trips_through_jax_and_loads_strict(tmp_path):
    sd = _unispeech_state_dict()
    back = tecapa.ecapa_state_dict_from_jax(jecapa.ecapa_params_from_torch(sd))
    assert sorted(back) == sorted(sd)
    for key in sd:
        assert back[key].dtype == sd[key].dtype and torch.equal(back[key], sd[key]), key
    # the checkpoint file: the WavLM extractor's keys beside the head's
    path = tmp_path / "ecapa.pt"
    torch.save({"model": {**sd, "feature_extract.model.w": torch.ones(3),
                          "feature_weight": torch.zeros(25)}}, path)
    model = tecapa.load_ecapa_checkpoint(str(path), device="cpu")
    assert not model.training
    for key, value in model.state_dict().items():
        assert torch.equal(value, sd[key]), key
    feats = np.random.default_rng(2).standard_normal((3, 41, 80)).astype(np.float32)
    want = np.asarray(jax.jit(jecapa.ecapa_embed)(jecapa.load_ecapa_checkpoint(str(path)),
                                                   jnp.asarray(feats)))
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    assert rel_err(got, want) <= ECAPA_TOL


def test_ecapa_mel_embedding_of_the_bundled_clip_matches_jax():
    sd = _unispeech_state_dict(seed=4)
    want = jecapa.make_mel_embed_fn(params=jecapa.ecapa_params_from_torch(sd))(str(CLIP))
    got = tecapa.make_mel_embed_fn(state_dict=sd, device="cpu")(str(CLIP))
    assert got.shape == want.shape == (32,) and np.isfinite(got).all()
    assert rel_err(got, want) <= ECAPA_CLIP_TOL
    sim = tue.run_sim([(str(CLIP), str(CLIP))], tecapa.make_mel_embed_fn(state_dict=sd,
                                                                           device="cpu"))
    assert sim[0]["sim"] == pytest.approx(1.0, abs=1e-4)


def test_make_mel_embed_fn_defaults_to_the_card():
    import inspect

    assert inspect.signature(tecapa.make_mel_embed_fn).parameters["device"].default == "cuda"
    assert inspect.signature(tscorers.default_speaker_embed_fn).parameters[
        "device"].default == "cuda"
    with pytest.raises(FileNotFoundError, match="ECAPA_CKPT"):
        tscorers.default_speaker_embed_fn(None)


# ---- batched test-set inference --------------------------------------------


def _clip(path: Path, seconds: float, freq: float) -> str:
    t = np.arange(int(SR * seconds)) / SR
    write_wav(str(path), (0.2 * np.sin(2 * np.pi * freq * t)
                          + 0.05 * np.sin(2 * np.pi * 3.3 * freq * t)).astype(np.float32), SR)
    return str(path)


@pytest.fixture(scope="module")
def eval_meta(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    a, b = _clip(d / "a.wav", 0.8, 190.0), _clip(d / "b.wav", 0.5, 260.0)
    return [("utt_a", "hello there, the first voice", a, "a much longer target text to say", ""),
            ("utt_b", "second voice", b, "short one", "")]


def _jax_mel_fn(jw):
    def mel_fn(wav):
        n = len(wav) // 256 * 256
        mel = jw._mel_jit(jnp.asarray(wav[None, :n]))
        return np.asarray(mel.swapaxes(1, 2)[0, : n // 256])

    return mel_fn


def _jax_noise(self, generator, n_frames):
    """`F5TTSWrapper._draw_noise` drawing what the JAX function draws for
    the generator's seed: ``jax.random.normal(key(seed), ...)``."""
    key = jax.random.key(generator.initial_seed())
    return torch.from_numpy(np.array(jax.random.normal(key, (n_frames, MEL), jnp.float32)))


def _record_samples(monkeypatch, cls) -> list:
    outs = []
    sample = cls.sample

    def recorded(self, *args, **kwargs):
        out = sample(self, *args, **kwargs)
        outs.append(np.asarray(out, np.float32) if not torch.is_tensor(out)
                    else out.float().numpy())
        return out

    monkeypatch.setattr(cls, "sample", recorded)
    return outs


def test_run_eval_inference_matches_jax(eval_meta, tmp_path, monkeypatch):
    """Two prompts of different lengths in one batch, the JAX noise handed
    in: the wavs within 1 LSB, the mels within 1e-4, the reports' counts."""
    jw, tw = tiny_wrappers()
    kw = dict(load_wav=read_wav, tokenize=list, min_seconds=0.2, max_seconds=2.4,
              num_buckets=1, batch_frames=4000)
    want_batches = jue.get_inference_prompt(eval_meta, mel_fn=_jax_mel_fn(jw), **kw)
    batches = tue.get_inference_prompt(eval_meta, mel_fn=_jax_mel_fn(jw), **kw)
    assert [len(b.utts) for b in batches] == [2]
    b = batches[0]
    assert b.ref_mel_lens[0] != b.ref_mel_lens[1] and b.total_mel_lens[0] != b.total_mel_lens[1]
    # the port's own frontend gives the same prompt frames (magnitudes within 1e-5)
    port_mel = tbatch.wrapper_mel_fn(tw)(read_wav(eval_meta[0][2])[0][0])
    jax_mel = _jax_mel_fn(jw)(read_wav(eval_meta[0][2])[0][0])
    assert port_mel.shape == jax_mel.shape
    assert np.abs(np.exp(port_mel) - np.exp(jax_mel)).max() <= 1e-5 * np.exp(jax_mel).max()

    jmels = _record_samples(monkeypatch, JCFM)
    tmels = _record_samples(monkeypatch, CFM)
    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", _jax_noise)
    want = jbatch.run_eval_inference(jw, want_batches, str(tmp_path / "j"), nfe_step=2, seed=3)
    got = tbatch.run_eval_inference(tw, batches, str(tmp_path / "t"), nfe_step=2, seed=3)
    assert len(jmels) == len(tmels) == 1
    np.testing.assert_allclose(tmels[0], jmels[0], atol=MEL_TOL)
    assert (got["utterances"], got["audio_seconds"], got["nfe_step"]) == (
        want["utterances"], want["audio_seconds"], want["nfe_step"]) == (2, got["audio_seconds"], 2)
    for i, utt in enumerate(b.utts):
        g, _ = read_wav(str(tmp_path / "t" / f"{utt}.wav"))
        w, _ = read_wav(str(tmp_path / "j" / f"{utt}.wav"))
        assert g.shape == w.shape == (1, int(b.total_mel_lens[i] - b.ref_mel_lens[i]) * 256)
        assert np.abs(w).max() > 1e-3
        assert np.abs(g - w).max() * 32767 <= PCM_LSB + 1e-6
    report = json.loads((tmp_path / "t" / "_eval_report.json").read_text())
    assert report == got


def test_split_between_processes_strides_like_jax():
    items = list(range(10))
    for index, count in ((0, 4), (3, 4), (1, 2), (0, 1)):
        assert tbatch.split_between_processes(items, index, count) == \
            jbatch.split_between_processes(items, index, count)
    # no process group: the whole list, as jax.process_index() 0 of 1
    assert tbatch.process_rank_and_count() == (0, 1)
    assert tbatch.split_between_processes(items) == items


def test_eval_infer_batch_main_on_a_checkpoint(tmp_path, monkeypatch, eval_meta):
    """The CLI as a user starts it (`-p`, `-v`, `-t`, `-o`) on a tiny
    reference-format checkpoint and vocab, `--device cpu`."""
    monkeypatch.setitem(twrapper.PRESETS, "tiny", CFG)
    dit = DiT(CFG.arch, len(VOCAB_MAP), MEL)
    torch.save({f"ema_model.{k}": torch.from_numpy(v) for k, v in
                backbone_state_dict_to_reference(dit.state_dict()).items()},
               tmp_path / "model.pt")
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB_MAP) + "\n", encoding="utf-8")
    meta = tmp_path / "meta.lst"
    meta.write_text("".join(f"{u}|{pt}|{pw}|{gt}\n" for u, pt, pw, gt, _ in eval_meta),
                    encoding="utf-8")
    out = tmp_path / "gen"
    report = tbatch.main(["-n", "tiny", "-p", str(tmp_path / "model.pt"),
                          "-v", str(tmp_path / "vocab.txt"), "-t", str(meta), "-o", str(out),
                          "--nfe_step", "2", "--device", "cpu"])
    assert report["utterances"] == 2 and report["nfe_step"] == 2
    for utt, *_ in eval_meta:
        wav, sr = read_wav(str(out / f"{utt}.wav"))
        assert sr == SR and wav.shape[1] > 0 and np.isfinite(wav).all()
    assert json.loads((out / "_eval_report.json").read_text()) == report


# ---- the infill battery -----------------------------------------------------

INFILL_ARCH = ArchConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32,
                         conv_layers=0, dropout=0.0)


def _tiny_arm_of(params, compute_dtype=None):
    """`tests/test_infill_eval.py`'s tiny arm: the JAX CFM and, on
    ``params`` (None: the JAX CFM alone), the port's CFM, both computing in
    ``compute_dtype`` (None: fp32)."""
    from eraxvif5tts_tpu.configs import ArchConfig as JArchConfig

    jarch = JArchConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32,
                        conv_layers=0, dropout=0.0)
    jdtype = jnp.float32 if compute_dtype is None else jnp.bfloat16
    jcfm = JCFM(transformer=JDiT(arch=jarch, text_num_embeds=16, mel_dim=100,
                                 compute_dtype=jdtype))
    if params is None:
        return jcfm, None
    dit = DiT(INFILL_ARCH, 16, 100, compute_dtype=compute_dtype)
    dit.load_state_dict(state_dict_from_jax(params, None, ModelConfig(arch=INFILL_ARCH))[0],
                        strict=True)
    return jcfm, CFM(dit.eval())


@pytest.fixture(scope="module")
def tiny_arm():
    """The tiny arm, its weights redrawn from a seeded normal (the JAX init
    leaves the output projection 0, and the mel then follows the noise
    alone), and the port's DiT on them."""
    params = redraw(_tiny_arm_of(None)[0].init_params(jax.random.key(0)), seed=3)
    rng = np.random.default_rng(0)
    rows = [
        {"text": "ab ba", "duration": 1.0,
         "mel_spec": rng.standard_normal((40, 100)).astype(np.float32)},
        {"text": "ba ab", "duration": 1.2,
         "mel_spec": rng.standard_normal((48, 100)).astype(np.float32)},
    ]
    jcfm, cfm = _tiny_arm_of(params)
    return jcfm, params, cfm, rows


def _jax_cell_noise(utt_idx, seed, n_frames, n_mels, device):
    key = jinfill._cell_key(utt_idx, seed)
    return torch.from_numpy(np.array(jax.random.normal(key, (n_frames, n_mels), jnp.float32)))


def test_evaluate_arm_matches_jax(tiny_arm, tmp_path, monkeypatch):
    jcfm, params, cfm, rows = tiny_arm
    vocab = tinfill.corpus_vocab(rows)
    assert vocab == jinfill.corpus_vocab(rows)
    monkeypatch.setattr(tinfill, "_cell_noise", _jax_cell_noise)
    want = jinfill.evaluate_arm(jcfm, params, rows, vocab, seeds=2, steps=2, arm="t",
                                save_dir=str(tmp_path / "j"))
    got = tinfill.evaluate_arm(cfm, rows, vocab, seeds=2, steps=2, arm="t",
                               save_dir=str(tmp_path / "t"))
    assert [(c["arm"], c["utt"], c["seed"]) for c in got] == \
        [(c["arm"], c["utt"], c["seed"]) for c in want]
    for g, w in zip(got, want):
        for key in ("infill_mel_l1", "ltas_corr_gen", "ltas_corr_full"):
            assert abs(g[key] - w[key]) <= 1e-4 + 1e-12, (key, g, w)
    for i in range(len(rows)):
        np.testing.assert_allclose(np.load(tmp_path / "t" / f"t_utt{i}.npy"),
                                   np.load(tmp_path / "j" / f"t_utt{i}.npy"), atol=MEL_TOL)
    # seeds differ: the grid is not degenerate
    assert got[0]["infill_mel_l1"] != got[1]["infill_mel_l1"]
    summary = tinfill._summarize(got)
    want_summary = jinfill._summarize(got)
    assert summary == want_summary and summary["infill_mel_l1"]["n"] == 4


def test_evaluate_arm_in_bf16_runs_the_feed_forward_on_kernel_2_and_matches_jax(
        tiny_arm, tmp_path, monkeypatch):
    """The infill arms' recipe: fp32 parameters computing in bf16. The port's
    feed-forward hands kernel 2 (here its plain version) bf16 copies of its
    weights, in every block at every step of both CFG rows, and the mels
    agree with the JAX arm in bf16."""
    from eraxvif5tts_tpu_torch.models import modules

    _, params, _, rows = tiny_arm
    jcfm, cfm = _tiny_arm_of(params, torch.bfloat16)
    vocab = tinfill.corpus_vocab(rows)
    monkeypatch.setattr(tinfill, "_cell_noise", _jax_cell_noise)
    calls, kernel = [], modules.ln_mod_matmul

    def counted(x, scale, shift, weight, bias, **kwargs):
        calls.append((x.dtype, weight.dtype, bias.dtype))
        return kernel(x, scale, shift, weight, bias, **kwargs)

    monkeypatch.setattr(modules, "ln_mod_matmul", counted)
    want = jinfill.evaluate_arm(jcfm, params, rows, vocab, seeds=2, steps=2, arm="b",
                                save_dir=str(tmp_path / "j"))
    got = tinfill.evaluate_arm(cfm, rows, vocab, seeds=2, steps=2, arm="b",
                               save_dir=str(tmp_path / "t"))
    # 2 blocks x 2 steps x 4 cells, the CFG rows in one call
    assert calls == [(torch.bfloat16,) * 3] * (2 * 2 * 4)
    assert all(v.dtype == torch.float32 for v in cfm.transformer.state_dict().values())
    for i in range(len(rows)):
        err = rel_err(np.load(tmp_path / "t" / f"b_utt{i}.npy"),
                      np.load(tmp_path / "j" / f"b_utt{i}.npy"))
        assert err <= BF16_MEL_TOL, (i, err)
    for g, w in zip(got, want):
        for key in ("infill_mel_l1", "ltas_corr_gen", "ltas_corr_full"):
            assert abs(g[key] - w[key]) <= BF16_CELL_TOL, (key, g, w)


def test_cell_key_scheme_and_host_functions():
    for utt, seed in ((0, 0), (2, 0), (1, 3)):
        g = tinfill._cell_key(utt, seed)
        assert g.initial_seed() == 7 + utt + 1000 * seed
        assert int(jax.random.key_data(jinfill._cell_key(utt, seed))[-1]) == g.initial_seed()
    rng = np.random.default_rng(1)
    for _ in range(3):
        a, b = rng.standard_normal((100, 50)), rng.standard_normal((100, 30))
        assert tinfill.ltas_corr(a, b) == jinfill.ltas_corr(a, b)
    cells = [{"infill_mel_l1": float(x), "ltas_corr_gen": float(y), "ltas_corr_full": 0.5}
             for x, y in rng.standard_normal((5, 2))]
    assert tinfill._summarize(cells) == jinfill._summarize(cells)
    assert tinfill._summarize(cells[:1]) == jinfill._summarize(cells[:1])
    assert tinfill.CORPUS == jinfill.CORPUS


def _corpus_root(tmp_path) -> Path:
    root = tmp_path / "reference"
    dst = root / tinfill.CORPUS[0][0]
    dst.parent.mkdir(parents=True)
    shutil.copyfile(CLIP, dst)
    return root


def test_load_corpus_and_arm_checkpoint_match_jax(tmp_path):
    from eraxvif5tts_tpu.ops.stft import MelSpectrogram as JMel
    from eraxvif5tts_tpu_torch.ops.stft import MelSpectrogram

    root = _corpus_root(tmp_path)
    want = jinfill.load_corpus(jax.jit(JMel().__call__), 24000, 256, root=str(root))
    mel = MelSpectrogram()
    got = tinfill.load_corpus(lambda w: mel(torch.from_numpy(w)).numpy(), 24000, 256,
                              root=str(root))
    assert len(got) == len(want) == 1
    assert (got[0]["text"], got[0]["duration"]) == (want[0]["text"], want[0]["duration"])
    g, w = np.exp(got[0]["mel_spec"]), np.exp(want[0]["mel_spec"])
    assert g.shape == w.shape and np.abs(g - w).max() <= 1e-5 * w.max()
    with pytest.raises(FileNotFoundError):
        tinfill.load_corpus(lambda w: w, 24000, 256, root=str(tmp_path / "none"))

    vocab = tinfill.corpus_vocab(got)
    dit = DiT(INFILL_ARCH, len(vocab), 100)
    ckpt = tmp_path / "arm.pt"
    torch.save({f"ema_model.{k}": torch.from_numpy(v) for k, v in
                backbone_state_dict_to_reference(dit.state_dict()).items()}, ckpt)
    cfm, depth = tinfill._load_arm_params(str(ckpt), ModelConfig(arch=INFILL_ARCH), vocab,
                                          torch.bfloat16, "cpu")
    assert depth == 2 and cfm.transformer.compute_dtype == torch.bfloat16
    for key, value in cfm.transformer.state_dict().items():
        assert value.dtype == torch.float32 and torch.equal(value, dit.state_dict()[key]), key
    with pytest.raises(ValueError, match="corpus vocab"):
        tinfill._load_arm_params(str(ckpt), ModelConfig(arch=INFILL_ARCH), {"a": 0},
                                 torch.bfloat16, "cpu")


def test_infill_subcommand_matches_jax():
    for parser in (jmain._parser(), tmain._parser()):
        assert "infill" in parser.format_help()
    j_sub = jmain._parser()._subparsers._group_actions[0].choices
    t_sub = tmain._parser()._subparsers._group_actions[0].choices
    assert sorted(t_sub) == sorted(j_sub)
    with pytest.raises(SystemExit) as e:
        tmain.main(["infill", "--help"])
    assert e.value.code == 0


# ---- scorers and the CLI ----------------------------------------------------


def test_eval_cli_subcommands_match_jax(tmp_path):
    """seedtts / librispeech / utmos with injected scorers in both packages:
    equal summaries and equal jsonl lines."""
    ref = _clip(tmp_path / "ref.wav", 0.25, 160.0)
    results = {}
    for name, main in (("jax", jmain.main), ("port", tmain.main)):
        gen = tmp_path / name
        gen.mkdir()
        for utt in ("utt1", "utt2", "1089-134686-0005", "1188-133604-0007"):
            _clip(gen / f"{utt}.wav", 0.125, 200.0)
        meta = tmp_path / "meta.lst"
        meta.write_text(f"utt1|prompt one|{ref}|target one\n"
                        f"utt2|prompt two|{ref}|target two|gt2.wav\n")
        ls_meta = tmp_path / "ls.lst"
        ls_meta.write_text(
            "1089-134686-0001\t3.0\tref text a\t1089-134686-0005\t4.0\tgen text a\n"
            "1188-133604-0002\t2.5\tref text b\t1188-133604-0007\t5.0\tgen text b\n")

        def asr(path):
            return "target one" if "utt1" in path else "wrong text"

        def embed(path):
            return (np.ones(4) if "utt" in os.path.basename(path)
                    else np.array([1.0, 0.2, 0, 0]))

        out = [main(["seedtts", "-m", str(meta), "-g", str(gen), "-e", "wer", "-n", "2"],
                    asr_fn=asr),
               main(["seedtts", "-m", str(meta), "-g", str(gen), "-e", "sim", "-l", "vi"],
                    embed_fn=embed),
               main(["librispeech", "-m", str(ls_meta), "-p", str(tmp_path), "-g", str(gen),
                     "-e", "wer"], asr_fn=lambda p: "gen text a" if "0005" in p else "gen b"),
               main(["utmos", "-g", str(gen)],
                    utmos_fn=lambda p: 3.0 + 0.1 * len(os.path.basename(p)))]
        lines = {f: (gen / f).read_text().replace(str(gen), "GEN")
                 for f in ("_wer_results.jsonl", "_sim_results.jsonl", "_utmos_results.jsonl")}
        results[name] = (out, lines)
    assert results["port"] == results["jax"]
    summaries = results["port"][0]
    assert summaries[0] == {"n": 2, "wer_mean": 0.5} and summaries[3]["n"] == 4


def test_sim_through_an_ecapa_checkpoint_matches_jax(tmp_path):
    """`-e sim --ecapa_ckpt` in both packages (the port's scorer on
    `--device cpu`): the sims within the clip limit, the same rows."""
    sd = _unispeech_state_dict(seed=5)
    ckpt = tmp_path / "ecapa.pt"
    torch.save({"model": sd}, ckpt)
    gen = tmp_path / "gen"
    gen.mkdir()
    prompt = _clip(tmp_path / "prompt.wav", 0.6, 450.0)
    _clip(gen / "utt1.wav", 0.5, 220.0)
    shutil.copyfile(prompt, gen / "utt2.wav")
    meta = tmp_path / "meta.lst"
    meta.write_text(f"utt1|p|{prompt}|g\nutt2|p|{prompt}|g\n")
    argv = ["seedtts", "-m", str(meta), "-g", str(gen), "-e", "sim", "--ecapa_ckpt", str(ckpt)]
    want = jmain.main(argv)
    want_rows = (gen / "_sim_results.jsonl").read_text().splitlines()
    got = tmain.main(argv + ["--device", "cpu"])
    got_rows = (gen / "_sim_results.jsonl").read_text().splitlines()
    assert got["n"] == want["n"] == 2
    assert abs(got["sim_mean"] - want["sim_mean"]) <= ECAPA_CLIP_TOL
    sims = [json.loads(line)["sim"] for line in got_rows[:2]]
    assert sims[1] == pytest.approx(1.0, abs=1e-4)  # a clip against itself
    for g, w in zip(got_rows[:2], want_rows[:2]):
        g, w = json.loads(g), json.loads(w)
        assert (g["gen"], g["prompt"]) == (w["gen"], w["prompt"])
        assert abs(g["sim"] - w["sim"]) <= ECAPA_CLIP_TOL


def test_scorer_directories_match_jax(tmp_path):
    gen = tmp_path / "gen"
    gen.mkdir()
    for i in range(5):
        _clip(gen / f"utt{i}.wav", 0.05 * (i + 1), 300.0)
    meta = [(f"utt{i}", "p", str(gen / "utt0.wav"), f"some words number {i}", "")
            for i in range(6)]  # utt5 has no wav: skipped
    scores = {f"utt{i}.wav": 3.0 + 0.1 * i for i in range(5)}

    def asr(path):
        i = int(os.path.basename(path)[3])
        return "some words" + (" number" if i % 2 else "") + f" {i}"

    def embed(path):
        return np.arange(1.0, 5.0) * (1 + int(os.path.basename(path)[3]))

    for fn, kw in ((tscorers.eval_wer_dir, dict(metainfo=meta, asr_fn=asr, num_workers=3)),
                   (tscorers.eval_sim_dir, dict(metainfo=meta, embed_fn=embed, num_workers=3)),
                   (tscorers.eval_utmos_dir,
                    dict(utmos_fn=lambda p: scores[os.path.basename(p)]))):
        jfn = getattr(jscorers, fn.__name__)
        got = fn(str(gen), out_jsonl=str(tmp_path / "t.jsonl"), **kw)
        want = jfn(str(gen), out_jsonl=str(tmp_path / "j.jsonl"), **kw)
        assert got == want and got["n"] == 5
        assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()


# ---- profiling ----------------------------------------------------------------


def test_device_trace_writes_a_trace_and_force_sync_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        y = (x @ x).relu()
        profiling.force_sync(y)
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
    profiling.force_sync(torch.tensor(3.0))


def test_rtf_meter_dump(tmp_path, monkeypatch):
    ticks = iter([0.0, 0.25, 2.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    meter = profiling.RTFMeter()
    meter.start_request()
    meter.record_chunk(48000)
    meter.end_request()
    meter.dump(str(tmp_path / "rtf.json"))
    assert json.loads((tmp_path / "rtf.json").read_text()) == {
        "rtf": 1.0, "audio_seconds": 2.0, "wall_seconds": 2.0, "first_chunk_p50_ms": 250.0,
        "requests": 1}
