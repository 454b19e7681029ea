"""PyTorch port, the fine-tuning project manager (`training/project.py`) and
the gradio-free core of its UI (`training/finetune_gradio.py`), driven
headless as `tests/test_finetune_ui.py` and `tests/test_prepare_project.py`
drive the JAX package's, with the JAX package's outputs as the expectation
where both write files: the extended checkpoint and the pruned EMA tensors
bit for bit, the same argv apart from the module name, the same project
files."""

import importlib.util
import inspect
import json
import os
import time

import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.training import finetune_gradio as jui
from eraxvif5tts_tpu.training import project as jproject
from eraxvif5tts_tpu_torch.audio.io import write_wav
from eraxvif5tts_tpu_torch.compression.convert import load_state_dict
from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
from eraxvif5tts_tpu_torch.training import cli as tcli
from eraxvif5tts_tpu_torch.training import finetune_gradio as ui
from eraxvif5tts_tpu_torch.training import project as tproject
from eraxvif5tts_tpu_torch.training.project import (
    DEFAULT_SETTINGS,
    ProjectStore,
    TrainingProcess,
    settings_to_cli_args,
)

SR = 24000
TEXTS = ["xin chao", "toi la robot", "hello world"]


def _make_project(store, ui_mod, name="demo", tokenizer="char"):
    _, full = ui_mod.ui_create_project(store, name, tokenizer)
    wav_dir = os.path.join(store.path(full), "wavs")
    for i, dur in enumerate((0.5, 0.8, 1.1)):
        wav = 0.1 * np.sin(np.linspace(0, 80, int(SR * dur))).astype(np.float32)
        write_wav(os.path.join(wav_dir, f"{i}.wav"), wav, SR)
    texts = iter(TEXTS)
    ui_mod.ui_transcribe(store, full, "", "vi", asr_fn=lambda p: next(texts))
    return full


@pytest.fixture()
def stores(tmp_path):
    """A project made by each package's callbacks: (JAX store, port store, name)."""
    jstore = jproject.ProjectStore(str(tmp_path / "jax"))
    tstore = ProjectStore(str(tmp_path / "port"))
    return jstore, tstore, _make_project(jstore, jui), _make_project(tstore, ui)


def _tree(root) -> dict:
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), root)
            out[rel] = open(os.path.join(base, f), "rb").read()
    return out


def test_project_layout_and_metadata_equal_jax(stores, tmp_path):
    jstore, tstore, jname, tname = stores
    assert tname == jname == "demo_char"
    assert tstore.list_projects() == jstore.list_projects()
    # the wav paths in metadata.csv name each store's root
    jtree = {k: v.replace(str(tmp_path / "jax").encode(), b"ROOT")
             for k, v in _tree(jstore.root).items()}
    ttree = {k: v.replace(str(tmp_path / "port").encode(), b"ROOT")
             for k, v in _tree(tstore.root).items()}
    assert ttree == jtree
    assert ui.ui_random_sample(tstore, tname, seed=0)[0] == jui.ui_random_sample(
        jstore, jname, seed=0)[0]
    assert tproject.random_metadata_sample(str(tmp_path / "nope.csv")) == ("", None)
    with pytest.raises(ValueError):
        ui.ui_create_project(tstore, "   ", "pinyin")


def test_vocab_check_and_extend_equal_jax(stores):
    jstore, tstore, jname, tname = stores
    for store, name in ((jstore, jname), (tstore, tname)):
        with open(os.path.join(store.path(name), "vocab.txt"), "w", encoding="utf-8") as f:
            f.write(" \nx\ni\nn\nc\nh\na\no\n")
    def rooted(out, store):  # the status lines name each store's root
        return tuple(x.replace(store.root, "ROOT") for x in out)

    missing = ui.ui_vocab_check(tstore, tname)
    assert rooted(missing, tstore) == rooted(jui.ui_vocab_check(jstore, jname), jstore)
    assert "t" in missing[0].split()
    out = ui.ui_vocab_extend(tstore, tname, missing[0], "", "")
    assert out == jui.ui_vocab_extend(jstore, jname, missing[0], "", "")
    assert ui.ui_vocab_check(tstore, tname) == ("", "vocab covers the dataset")
    assert (open(os.path.join(tstore.path(tname), "vocab.txt")).read()
            == open(os.path.join(jstore.path(jname), "vocab.txt")).read())
    assert ui.ui_vocab_extend(tstore, tname, "  ", "", "") == "no symbols to add"
    for text in ("a b  c", "", "x\ty z"):
        assert tproject.vocab_count(text) == jproject.vocab_count(text)


def _reference_checkpoint(path, rows=11, width=8, seed=0):
    rng = np.random.default_rng(seed)
    sd = {"ema_model.transformer.text_embed.text_embed.weight":
          torch.from_numpy(rng.standard_normal((rows, width)).astype(np.float32)),
          "ema_model.transformer.proj_out.weight":
          torch.from_numpy(rng.standard_normal((4, width)).astype(np.float32)),
          "ema_model.transformer.proj_out.bias": torch.zeros(4),
          "initted": torch.tensor(True), "step": torch.tensor(5)}
    torch.save({"ema_model_state_dict": sd,
                "model_state_dict": {k.replace("ema_model.", ""): v for k, v in sd.items()
                                     if k.startswith("ema_model.")},
                "optimizer_state_dict": {"state": {}, "param_groups": []}, "update": 5}, path)


@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
def test_vocab_extend_expands_the_checkpoint_bit_for_bit(tmp_path, suffix):
    src = tmp_path / "model.pt"
    _reference_checkpoint(src)
    out = {}
    for name, mod in (("jax", jproject), ("port", tproject)):
        vocab = tmp_path / f"{name}_vocab.txt"
        vocab.write_text("".join(f"{c}\n" for c in " abcdefghij"), encoding="utf-8")
        new_size = mod.vocab_extend(str(vocab), ["k", "a", "l", ""], str(src),
                                    str(tmp_path / f"{name}{suffix}"))
        out[name] = (new_size, vocab.read_text(encoding="utf-8"),
                     load_state_dict(str(tmp_path / f"{name}{suffix}")))
    (got_n, got_vocab, got), (want_n, want_vocab, want) = out["port"], out["jax"]
    assert (got_n, got_vocab) == (want_n, want_vocab) and got_n == 13
    assert sorted(got) == sorted(want)
    for key in got:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert got["transformer.text_embed.text_embed.weight"].shape == (14, 8)


def test_prune_checkpoint_to_ema_bit_for_bit(tmp_path):
    src = tmp_path / "full.pt"
    _reference_checkpoint(src, seed=1)
    for suffix in (".pt", ".safetensors"):
        n = tproject.prune_checkpoint_to_ema(str(src), str(tmp_path / f"t{suffix}"))
        assert n == jproject.prune_checkpoint_to_ema(str(src), str(tmp_path / f"j{suffix}")) == 3
        got = load_state_dict(str(tmp_path / f"t{suffix}"))
        want = load_state_dict(str(tmp_path / f"j{suffix}"))
        assert sorted(got) == sorted(want) == ["transformer.proj_out.bias",
                                                "transformer.proj_out.weight",
                                                "transformer.text_embed.text_embed.weight"]
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])
    dst = str(tmp_path / "u.pt")
    assert ui.ui_prune(str(src), dst) == jui.ui_prune(str(src), dst) == f"kept 3 tensors -> {dst}"


def test_prepare_and_auto_settings_equal_jax(stores):
    jstore, tstore, jname, tname = stores
    got = json.loads(ui.ui_prepare(tstore, tname))
    want = json.loads(jui.ui_prepare(jstore, jname))
    assert got == want and got["samples"] == 3
    for settings in (dict(DEFAULT_SETTINGS), {**DEFAULT_SETTINGS, "finetune": False},
                     {**DEFAULT_SETTINGS, "batch_size_type": "sample"}):
        assert ui.ui_calculate_train(tstore, tname, settings) == jui.ui_calculate_train(
            jstore, jname, settings)
    path = os.path.join(tstore.path(tname), "duration.json")
    for kw in (dict(hbm_gb=80.0), dict(n_chips=4, batch_size_type="sample")):
        assert tproject.calculate_train(path, **kw) == jproject.calculate_train(path, **kw)
    with pytest.raises(FileNotFoundError):
        tproject.calculate_train(os.path.join(tstore.root, "missing.json"))


def test_settings_round_trip_and_argv_equal_jax(stores):
    jstore, tstore, jname, tname = stores
    values = list(ui.ui_load_settings(tstore, tname))
    assert values == jui.ui_load_settings(jstore, jname)
    assert ui.SETTING_FIELDS == jui.SETTING_FIELDS
    values[ui.SETTING_FIELDS.index("learning_rate")] = "3e-05"
    values[ui.SETTING_FIELDS.index("epochs")] = "7"
    values[ui.SETTING_FIELDS.index("finetune")] = "false"
    assert "saved" in ui.ui_save_settings(tstore, tname, *values)
    jui.ui_save_settings(jstore, jname, *values)
    assert ui.ui_load_settings(tstore, tname) == jui.ui_load_settings(jstore, jname)
    assert (open(os.path.join(tstore.path(tname), "setting.json")).read()
            == open(os.path.join(jstore.path(jname), "setting.json")).read())
    with pytest.raises(ValueError):
        tstore.save_settings(tname, {"not_a_setting": 1})

    s = {**DEFAULT_SETTINGS, "finetune": False, "epochs": 3,
         "file_checkpoint_train": "ck.pt", "tokenizer_file": "v.txt"}
    argv = settings_to_cli_args(tname, s, "data")
    assert argv == jproject.settings_to_cli_args(tname, s, "data")
    assert argv[0] == "finetune"
    # the port's finetune parser takes every flag the bridge writes
    args = tcli.finetune_parser().parse_args(argv[1:])
    assert (args.dataset_name, args.epochs, args.finetune, args.pretrain,
            args.tokenizer_path, args.compute_dtype) == (tname, 3, False, "ck.pt", "v.txt",
                                                         "bfloat16")
    assert args.checkpoint_dir == os.path.join("data", tname, "ckpts")
    assert args.device == "cuda"


def test_training_lifecycle_and_log_tail(stores):
    _, tstore, _, tname = stores
    launched = {}

    class FakeProc(TrainingProcess):
        def start(self, args, log_path="train.log"):
            launched["args"], launched["log"] = args, log_path
            with open(log_path, "w") as f:
                f.write("step 1 loss 3.14\nstep 2 loss 2.71\n")
            return 4242

        @property
        def running(self):
            return False

    proc = FakeProc()
    msg = ui.ui_start_training(tstore, proc, tname, *ui.ui_load_settings(tstore, tname))
    assert "4242" in msg and launched["args"][0] == "finetune"
    assert launched["log"] == os.path.join(tstore.path(tname), "train.log")
    assert os.path.isfile(os.path.join(tstore.path(tname), "setting.json"))
    assert "loss 2.71" in ui.ui_tail_log(tstore, tname)
    assert ui.ui_stop_training(proc) == "not running"


def test_training_process_runs_the_ports_cli(tmp_path):
    """The real subprocess: `python -m eraxvif5tts_tpu_torch.training.cli
    finetune --help` exits 0 and prints the port's parser."""
    proc = TrainingProcess()
    log = tmp_path / "t.log"
    assert proc.start(["finetune", "--help"], log_path=str(log)) > 0
    deadline = time.monotonic() + 120
    while proc.running and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not proc.running
    assert proc.proc.returncode == 0
    text = log.read_text()
    assert "usage: eraxvif5tts-torch-finetune" in text and "--compute_dtype" in text
    assert ui.ui_stop_training(proc) == "not running"


def test_checkpoint_and_sample_listing_equal_jax(stores):
    jstore, tstore, jname, tname = stores
    for store, name in ((jstore, jname), (tstore, tname)):
        d = store.ckpt_dir(name)
        os.makedirs(os.path.join(d, "samples"))
        for f in ("model_500.pt", "model_1000.pt", "model_last.pt", "pretrained_base.pt",
                  "model_500.pt.meta.json", "samples/update_100.wav", "samples/x.txt"):
            open(os.path.join(d, f), "w").close()
    got = [os.path.relpath(p, tstore.root) for p in ui.ui_list_checkpoints(tstore, tname)]
    assert got == [os.path.relpath(p, jstore.root) for p in jui.ui_list_checkpoints(jstore, jname)]
    assert [os.path.basename(p) for p in got] == ["pretrained_base.pt", "model_500.pt",
                                                  "model_1000.pt", "model_last.pt"]
    assert [os.path.basename(p) for p in ui.ui_list_samples(tstore, tname)] == [
        "update_100.wav"]
    assert ui.ui_list_checkpoints(tstore, "missing_project") == []


def test_test_model_tab(stores, tmp_path, monkeypatch):
    _, tstore, _, tname = stores
    ref = str(tmp_path / "ref.wav")
    write_wav(ref, 0.05 * np.ones(SR // 2, np.float32), SR)

    class FakeTTS:
        target_sample_rate = SR

        def preprocess_reference(self, audio, text):
            self.ref = (audio, text)

        def generate(self, text, nfe_step=32, speed=1.0):
            assert nfe_step == 8 and speed == pytest.approx(1.2)
            return np.zeros(SR, np.float32)

    sr, wav = ui.ui_test_infer(tstore, tname, "ckpt.pt", ref, "hi", "xin chao", nfe=8,
                               speed=1.2, wrapper_factory=lambda c, v: FakeTTS())
    assert sr == SR and wav.shape == (SR,)
    with pytest.raises(ValueError):
        ui.ui_test_infer(tstore, tname, "", ref, "", "x")

    # the default factory: the port's wrapper in bf16, on the card unless asked
    assert inspect.signature(ui.ui_test_infer).parameters["device"].default == "cuda"
    built = {}

    class Spy:
        def __init__(self, **kwargs):
            built.update(kwargs)

        target_sample_rate = SR
        preprocess_reference = FakeTTS.preprocess_reference

        def generate(self, text, nfe_step=32, speed=1.0):
            return np.ones(4, np.float32)

    monkeypatch.setattr(twrapper, "F5TTSWrapper", Spy)
    ui.ui_test_infer(tstore, tname, "ck.pt", ref, "hi", "x", nfe=8, device="cpu")
    assert built == {"model_name": "F5TTS_v1_Base", "ckpt_path": "ck.pt", "vocab_file": None,
                     "compute_dtype": "bfloat16", "device": "cpu"}


def test_system_stats_and_build_app():
    stats = json.loads(ui.ui_system_stats())
    assert "loadavg" in stats and "mem_total" in stats
    if not torch.cuda.is_available():
        assert "devices" not in stats  # no accelerator is invented
    if importlib.util.find_spec("gradio") is None:
        with pytest.raises(ImportError, match="gradio"):
            ui.build_app()
