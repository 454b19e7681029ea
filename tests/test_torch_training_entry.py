"""PyTorch port, the training entry points from argv (`training/cli.py`
``finetune_main`` / ``train_main``, `training/distill_cli.py` ``main``) and the
from-scratch init (`training/scratch_init.py`), on the CPU at tiny widths
(the presets the CLIs read are patched to a dim-32 DiT in both packages).

- ``finetune_main`` on a dataset prepared by the port's ``prepare_csv_wavs``
  with a reference-format ``--pretrain`` whose vocabulary is smaller than the
  dataset's: the initial weights equal, bit for bit, what the JAX CLI loads
  (``expand_text_embedding`` then ``backbone_params_from_torch``); then a
  run with the duration predictor to its files.
- ``train_main`` from a tiny YAML.
- ``--from-scratch``: each parameter gets the rule of its JAX counterpart
  (zeros and ones exactly; the random ones' spread within 25 % of the JAX
  draw's and their peak within 35 %, which tells a uniform draw, peak
  sqrt(3) std, from a normal one, peak about 3.5 std), seeded per parameter
  name; the EMA and the align copy are buffers of their own.
- ``distill_cli.main`` with ``--export_path``: its keys and shapes equal the
  JAX CLI's export's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu import configs as jconfigs
from eraxvif5tts_tpu.compression.convert import backbone_params_from_torch
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu.models.duration import DurationPredictor as JDurationPredictor
from eraxvif5tts_tpu.training import distill_cli as jdistill_cli
from eraxvif5tts_tpu.training.scratch_init import init_weights_tts as j_init_weights_tts
from eraxvif5tts_tpu_torch import configs as tconfigs
from eraxvif5tts_tpu_torch.audio.io import write_wav
from eraxvif5tts_tpu_torch.compression.convert import (
    load_state_dict,
    normalize_reference_state_dict,
    state_dict_from_jax,
)
from eraxvif5tts_tpu_torch.compression.pruner import expand_text_embedding, save_state_dict
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.models.duration import DurationPredictor, duration_state_dict_from_jax
from eraxvif5tts_tpu_torch.training import cli, distill_cli
from eraxvif5tts_tpu_torch.training.prepare import prepare_csv_wavs
from eraxvif5tts_tpu_torch.training.scratch_init import flax_paths, init_rule, init_weights_tts

SR = 24000
TINY = dict(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, text_dim=16, conv_layers=1)


@pytest.fixture()
def tiny_presets(monkeypatch):
    """F5TTS_v1_Base cut to TINY in both packages (the CLIs read the preset)."""
    for mod in (tconfigs, jconfigs):
        base = mod.PRESETS["F5TTS_v1_Base"]
        monkeypatch.setitem(mod.PRESETS, "F5TTS_v1_Base", dataclasses.replace(
            base, arch=dataclasses.replace(base.arch, **TINY)))
    return tconfigs.PRESETS["F5TTS_v1_Base"]


@pytest.fixture()
def prepared(tmp_path):
    """A prepared dataset `data/tiny_char` of five clips (char vocabulary)."""
    pytest.importorskip("datasets")
    src = tmp_path / "src"
    (src / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i, text in enumerate(["hello there", "a cat sat.", "big dogs run", "why not", "ok"]):
        wav = (0.1 * rng.standard_normal(int(SR * (0.4 + 0.1 * i)))).astype(np.float32)
        write_wav(str(src / "wavs" / f"{i}.wav"), wav, SR)
        lines.append(f"wavs/{i}.wav|{text}")
    (src / "metadata.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    prepare_csv_wavs(str(src), str(tmp_path / "data" / "tiny_char"), use_pinyin=False)
    vocab = (tmp_path / "data" / "tiny_char" / "vocab.txt").read_text("utf-8").splitlines()
    return tmp_path / "data", len(vocab)


def _reference_checkpoint(path, arch, vocab, seed=0):
    """A reference-format checkpoint (EMA-prefixed keys) of a seeded DiT."""
    torch.manual_seed(seed)
    dit = DiT(arch, vocab, 100)
    sd = {f"ema_model.transformer.{k}": v.numpy() for k, v in dit.state_dict().items()}
    save_state_dict({**sd, "step": np.array(5)}, str(path))


def _finetune_argv(data_dir, tmp_path, *extra):
    return ["--dataset_name", "tiny", "--tokenizer", "char", "--data-dir", str(data_dir),
            "--batch_size_per_gpu", "300", "--max_samples", "2", "--num_warmup_updates", "1",
            "--save_per_updates", "2", "--last_per_updates", "0", "--logger", "none",
            "--checkpoint_dir", str(tmp_path / "ckpts"), "--device", "cpu", *extra]


def test_finetune_main_loads_the_extended_pretrain_as_jax_does(tiny_presets, prepared, tmp_path):
    data_dir, vocab = prepared
    pretrain = tmp_path / "pretrain.pt"
    _reference_checkpoint(pretrain, tiny_presets.arch, vocab - 4)  # the dataset outgrew it
    state = cli.finetune_main(_finetune_argv(data_dir, tmp_path, "--pretrain", str(pretrain),
                                             "--epochs", "0"))
    sd = expand_text_embedding(normalize_reference_state_dict(load_state_dict(str(pretrain))),
                               vocab)
    want = state_dict_from_jax(backbone_params_from_torch(sd, "DiT", depth=TINY["depth"],
                                                          conv_layers=TINY["conv_layers"]),
                               None, tiny_presets)[0]
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert got["text_embed.text_embed.weight"].shape[0] == vocab + 1
    for k, p in state.params.items():  # the EMA starts as its own copy
        assert torch.equal(state.ema_params[k], p) and state.ema_params[k].data_ptr() != p.data_ptr()

    # one epoch with the curriculum, to its files
    state = cli.finetune_main(_finetune_argv(
        data_dir, tmp_path, "--pretrain", str(pretrain), "--epochs", "1",
        "--use_duration_predictor", "--duration_focus_updates", "1", "--log_samples",
        "--checkpoint_dir", str(tmp_path / "run")))
    assert state.step >= 2 and state.dur_predictor is not None
    run = tmp_path / "run"
    assert (run / "model_last").is_dir() and (run / "duration_predictor_last.pt").is_file()
    assert (run / "samples" / "update_2_0.gl.wav").is_file()


def test_train_main_runs_from_a_tiny_yaml(prepared, tmp_path):
    data_dir, _ = prepared
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(f"""
datasets: {{name: tiny, batch_size_per_gpu: 300, batch_size_type: frame, max_samples: 2,
           num_workers: 2}}
optim: {{epochs: 2, learning_rate: 1.0e-4, num_warmup_updates: 1}}
model:
  name: tiny
  tokenizer: char
  arch: {{dim: 32, depth: 1, heads: 2, dim_head: 16, ff_mult: 2, text_dim: 16,
         conv_layers: 0, checkpoint_activations: true}}
ckpts: {{logger: null, log_samples: false, save_per_updates: 3, last_per_updates: 0,
        save_dir: {tmp_path / "ckpts"}}}
""", encoding="utf-8")
    state = cli.train_main([str(yaml), "--data-dir", str(data_dir), "--device", "cpu"])
    assert state.step > 3 and (tmp_path / "ckpts" / "model_last").is_dir()
    assert (tmp_path / "ckpts" / "model_3").is_dir()
    assert all(torch.isfinite(p).all() for p in state.params.values())
    # resume from model_last: its sidecar, written at the end as the JAX CLI
    # writes it, points at the start of the last epoch, which runs again
    again = cli.train_main([str(yaml), "--data-dir", str(data_dir), "--device", "cpu",
                            "--resume", str(tmp_path / "ckpts" / "model_last")])
    assert again.step == state.step + state.step // 2


def _spread(a):
    a = np.asarray(a, np.float64).ravel()
    if np.all(a == 0):
        return "zeros", 0.0, 0.0
    if np.all(a == 1):
        return "ones", 0.0, 0.0
    return "random", a.std(), np.abs(a).max()


def test_from_scratch_rules_match_jax(tiny_presets, prepared, tmp_path):
    data_dir, vocab = prepared
    arch = dataclasses.replace(tiny_presets.arch, dim=64, heads=4, text_dim=32)
    jcfm = JCFM(transformer=JDiT(arch=jconfigs.ArchConfig(**dataclasses.asdict(arch)),
                                 text_num_embeds=vocab, mel_dim=100))
    jparams = j_init_weights_tts(jcfm.init_params(jax.random.key(0)), jax.random.key(1))
    want = state_dict_from_jax(jparams, None, dataclasses.replace(tiny_presets, arch=arch))[0]
    dit = init_weights_tts(DiT(arch, vocab, 100), seed=3)
    got = dit.state_dict()
    jdp = JDurationPredictor(vocab_size=40, d_model=64, d_filter=32)
    ids = jax.numpy.zeros((1, 8), jax.numpy.int32)
    dwant = duration_state_dict_from_jax(j_init_weights_tts(
        jax.jit(jdp.init)(jax.random.key(0), ids, ids > 0)["params"], jax.random.key(2)))
    dgot = init_weights_tts(DurationPredictor(40, 64, 32), seed=3).state_dict()
    dgot["text_embed.weight"] = dgot["text_embed.weight"][1:]  # the JAX table has no filler row
    dwant["text_embed.weight"] = dwant["text_embed.weight"][1:]
    for what, g_sd, w_sd in (("dit", got, want), ("duration", dgot, dwant)):
        assert set(g_sd) == set(w_sd), what
        for k, w in w_sd.items():
            gk, gs, gm = _spread(g_sd[k])
            wk, ws, wm = _spread(w)
            assert gk == wk, (what, k, gk, wk)
            if gk == "random" and w.numel() >= 512:
                assert abs(gs / ws - 1) < 0.25 and abs(gm / wm - 1) < 0.35, (what, k, gs, ws,
                                                                             gm, wm)
    # the rule of each parameter is read off its flax path: spot checks
    paths = flax_paths(dit)
    assert paths["transformer_blocks.0.attn.to_q.weight"] == (
        "block_0/attn/to_q/kernel", "linear")
    assert init_rule("block_0/attn_norm/linear/kernel", (64, 384)) == ("zeros", 0.0)
    assert init_rule("block_0/ff/project_in/kernel", (64, 128))[0] == "uniform"
    # seeded per name: the same seed gives the same draws, another seed others
    again = init_weights_tts(DiT(arch, vocab, 100), seed=3).state_dict()
    other = init_weights_tts(DiT(arch, vocab, 100), seed=4).state_dict()
    key = "transformer_blocks.1.ff.ff.0.0.weight"
    assert torch.equal(again[key], got[key]) and not torch.equal(other[key], got[key])

    # through the CLI: the EMA and the align copy are buffers of their own
    state = cli.finetune_main(_finetune_argv(data_dir, tmp_path, "--from-scratch", "--epochs",
                                             "0", "--use_duration_predictor"))
    for k, p in state.params.items():
        assert torch.equal(state.ema_params[k], p) and state.ema_params[k].data_ptr() != p.data_ptr()
    assert torch.all(state.params["transformer_blocks.0.attn_norm.linear.weight"] == 0)
    for (k, p), a in zip(state.dur_predictor.named_parameters(), state.dur_align.parameters()):
        assert torch.equal(p, a) and p.data_ptr() != a.data_ptr() and not a.requires_grad, k


def test_distill_cli_main_exports_the_jax_keys(tiny_presets, prepared, tmp_path, capsys):
    data_dir, vocab = prepared
    teacher = tmp_path / "teacher.pt"
    _reference_checkpoint(teacher, tiny_presets.arch, vocab)
    common = ["--teacher_ckpt", str(teacher), "--student_depth", "1", "--dataset_name", "tiny",
              "--tokenizer", "char", "--data-dir", str(data_dir), "--epochs", "1",
              "--batch_size_per_gpu", "300", "--max_samples", "2", "--num_warmup_updates", "1",
              "--log_every", "1", "--save_per_updates", "2", "--compute_dtype", "float32"]
    state = distill_cli.main(common + ["--checkpoint_dir", str(tmp_path / "t"), "--export_path",
                                       str(tmp_path / "t.pt"), "--device", "cpu"])
    assert state.step >= 2 and "distill_loss=" in capsys.readouterr().out
    assert (tmp_path / "t" / "model_2").is_dir() and (tmp_path / "t" / "model_last").is_dir()
    jdistill_cli.main(common + ["--checkpoint_dir", str(tmp_path / "j"), "--export_path",
                                str(tmp_path / "j.pt")])
    got = torch.load(tmp_path / "t.pt", weights_only=True)
    want = torch.load(tmp_path / "j.pt", weights_only=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
    # bare --resume takes model_last, whose sidecar (as the JAX CLI writes it)
    # points at the start of the last epoch: that epoch runs again
    again = distill_cli.main(common + ["--checkpoint_dir", str(tmp_path / "t"), "--export_path",
                                       str(tmp_path / "t2.pt"), "--device", "cpu", "--resume"])
    assert again.step == 2 * state.step
