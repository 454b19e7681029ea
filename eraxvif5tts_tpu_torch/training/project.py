"""Finetuning project management (port of `eraxvif5tts_tpu/training/project.py`):
the library core behind the reference's Gradio training UI
(`src/f5_tts/train/finetune_gradio.py`, 2162 LoC of UI around these
operations). The functions are UI-agnostic; a thin gradio shim can wrap them when
gradio is installed.

Covered operations:
- batch transcription of a wav directory (`finetune_gradio.py:656`);
- metadata/arrow creation (`:765`) -> see `training/prepare.py`;
- vocab check + extension with embedding expansion (`:1020-1073`, `:1294`);
- checkpoint prune-to-EMA (`prune_checkpoint` `:994`): strip optimizer state, keep
  EMA weights only;
- training-process launch/stop via subprocess (`:363-631`): ``python -m
  eraxvif5tts_tpu_torch.training.cli``;
- host/accelerator stats (`:1565-1644`): the CUDA devices and their byte
  counters.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Optional

import torch


def transcribe_directory(wav_dir: str, output_csv: str, language: Optional[str] = None,
                         asr_fn=None) -> int:
    """Whisper-transcribe every wav -> `metadata.csv` rows `path|text`."""
    if asr_fn is None:
        from eraxvif5tts_tpu_torch.infer.utils_infer import transcribe

        asr_fn = lambda p: transcribe(p, language=language)  # noqa: E731
    n = 0
    with open(output_csv, "w", encoding="utf-8") as out:
        for name in sorted(os.listdir(wav_dir)):
            if not name.lower().endswith((".wav", ".flac")):
                continue
            path = os.path.join(wav_dir, name)
            text = asr_fn(path)
            out.write(f"{path}|{text}\n")
            n += 1
    return n


def vocab_check(metadata_csv: str, vocab_file: str, use_pinyin: bool = True) -> list[str]:
    """Tokens present in the dataset but missing from the vocab
    (`finetune_gradio.py:1294` ``vocab_check``)."""
    from eraxvif5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
    from eraxvif5tts_tpu_torch.text.tokenizer import read_vocab

    vocab = read_vocab(vocab_file)
    missing: set[str] = set()
    with open(metadata_csv, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 2:
                continue
            tokens = convert_char_to_pinyin([parts[1]])[0] if use_pinyin else list(parts[1])
            missing.update(t for t in tokens if t not in vocab)
    return sorted(missing)


def vocab_extend(vocab_file: str, new_tokens: list[str], ckpt_path: Optional[str] = None,
                 output_ckpt: Optional[str] = None) -> int:
    """Append tokens to vocab.txt and expand the checkpoint's embedding table
    (`finetune_gradio.py:1020-1073`). Returns new vocab size."""
    from eraxvif5tts_tpu_torch.text.tokenizer import read_vocab

    vocab = read_vocab(vocab_file)
    additions = [t for t in new_tokens if t and t not in vocab]
    if additions:
        with open(vocab_file, "a", encoding="utf-8") as f:
            for t in additions:
                f.write(t + "\n")
    new_size = len(vocab) + len(additions)

    if ckpt_path and output_ckpt:
        from eraxvif5tts_tpu_torch.compression.convert import (
            load_state_dict,
            normalize_reference_state_dict,
        )
        from eraxvif5tts_tpu_torch.compression.pruner import expand_text_embedding, save_state_dict

        sd = normalize_reference_state_dict(load_state_dict(ckpt_path))
        sd = expand_text_embedding(sd, new_size)
        save_state_dict(sd, output_ckpt)
    return new_size


def prune_checkpoint_to_ema(ckpt_path: str, output_path: str) -> int:
    """Strip optimizer/scheduler state, keep EMA weights only
    (`finetune_gradio.py:994` ``prune_checkpoint``). Returns tensor count."""
    from eraxvif5tts_tpu_torch.compression.convert import (
        load_state_dict,
        normalize_reference_state_dict,
    )
    from eraxvif5tts_tpu_torch.compression.pruner import save_state_dict

    sd = normalize_reference_state_dict(load_state_dict(ckpt_path), use_ema=True)
    save_state_dict(sd, output_path)
    return len(sd)


class TrainingProcess:
    """Launch/stop a training subprocess (`finetune_gradio.py:363-631`)."""

    def __init__(self):
        self.proc: Optional[subprocess.Popen] = None

    def start(self, args: list[str], log_path: str = "train.log") -> int:
        assert self.proc is None or self.proc.poll() is not None, "already running"
        with open(log_path, "a") as log:  # the child keeps its own descriptor
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "eraxvif5tts_tpu_torch.training.cli", *args],
                stdout=log, stderr=subprocess.STDOUT,
            )
        return self.proc.pid

    def stop(self) -> bool:
        if self.proc is None or self.proc.poll() is not None:
            return False
        self.proc.send_signal(signal.SIGINT)
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
        return True

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


def system_stats() -> dict:
    """Host + accelerator utilization snapshot (`finetune_gradio.py:1565-1644`)."""
    stats: dict = {}
    try:
        la1, la5, la15 = os.getloadavg()
        stats["loadavg"] = [la1, la5, la15]
    except OSError:
        pass
    try:
        with open("/proc/meminfo") as f:
            mem = {l.split(":")[0]: l.split(":")[1].strip() for l in f}
        stats["mem_total"] = mem.get("MemTotal")
        stats["mem_available"] = mem.get("MemAvailable")
    except OSError:
        pass
    if torch.cuda.is_available():
        stats["devices"] = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                            for i in range(torch.cuda.device_count())]
        free, total = torch.cuda.mem_get_info(0)
        stats["device_memory"] = {
            "total_bytes": int(total), "free_bytes": int(free),
            **{k: int(v) for k, v in torch.cuda.memory_stats(0).items() if "bytes" in k}}
    return stats


# ---------------------------------------------------------------------------
# project store: the directory layout + per-project settings behind the UI
# (`finetune_gradio.py:632-654` project listing/creation, `:61-171` settings)


DEFAULT_SETTINGS: dict = {
    "exp_name": "F5TTS_v1_Base",
    "learning_rate": 1e-5,
    "batch_size_per_gpu": 3200,
    "batch_size_type": "frame",
    "max_samples": 64,
    "grad_accumulation_steps": 1,
    "max_grad_norm": 1.0,
    "epochs": 100,
    "num_warmup_updates": 100,
    "save_per_updates": 500,
    "keep_last_n_checkpoints": -1,
    "last_per_updates": 100,
    "finetune": True,
    "file_checkpoint_train": "",
    "tokenizer_type": "pinyin",
    "tokenizer_file": "",
    # the training compute dtype instead of the reference's fp16
    # mixed_precision knob (the JAX package's setting, which the port keeps)
    "compute_dtype": "bfloat16",
    "logger": "tensorboard",
}


class ProjectStore:
    """Filesystem project registry (``{root}/{name}_{tokenizer}/``), mirroring the
    reference data layout so its datasets drop in unchanged."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def list_projects(self) -> list[str]:
        out = [d for d in sorted(os.listdir(self.root))
               if os.path.isdir(os.path.join(self.root, d))]
        return out

    def create(self, name: str, tokenizer_type: str = "pinyin") -> str:
        full = f"{name}_{tokenizer_type}"
        path = self.path(full)
        os.makedirs(os.path.join(path, "dataset"), exist_ok=True)
        os.makedirs(os.path.join(path, "wavs"), exist_ok=True)
        return full

    def path(self, project: str) -> str:
        return os.path.join(self.root, project)

    def ckpt_dir(self, project: str) -> str:
        return os.path.join(self.path(project), "ckpts")

    # -- settings ----------------------------------------------------------

    def save_settings(self, project: str, settings: dict) -> str:
        import json

        unknown = set(settings) - set(DEFAULT_SETTINGS)
        if unknown:
            raise ValueError(f"unknown setting(s): {sorted(unknown)}")
        merged = {**DEFAULT_SETTINGS, **settings}
        os.makedirs(self.path(project), exist_ok=True)
        p = os.path.join(self.path(project), "setting.json")
        with open(p, "w", encoding="utf-8") as f:
            json.dump(merged, f, indent=2)
        return p

    def load_settings(self, project: str) -> dict:
        import json

        p = os.path.join(self.path(project), "setting.json")
        out = dict(DEFAULT_SETTINGS)
        if os.path.isfile(p):
            with open(p, encoding="utf-8") as f:
                out.update(json.load(f))
        return out

    # -- checkpoints + samples (`finetune_gradio.py:1510-1562`) ------------

    def list_checkpoints(self, project: str) -> list[str]:
        """The trainer's ``model_*`` dirs + torch ``.pt``: pretrained first, then by
        step, then ``model_last`` (reference ordering)."""
        d = self.ckpt_dir(project)
        if not os.path.isdir(d):
            return []
        entries = [e for e in os.listdir(d)
                   if e.startswith(("model_", "pretrained_")) and
                   not e.endswith(".meta.json")]

        def step_of(e: str) -> int:
            stem = e.split(".")[0]
            try:
                return int(stem.split("_")[1])
            except (IndexError, ValueError):
                return 0

        pre = sorted(e for e in entries if e.startswith("pretrained_"))
        last = [e for e in entries if e.split(".")[0] == "model_last"]
        regular = sorted((e for e in entries if not e.startswith("pretrained_")
                          and e.split(".")[0] != "model_last"), key=step_of)
        return [os.path.join(d, e) for e in pre + regular + last]

    def list_sample_audio(self, project: str) -> list[str]:
        """Per-save synthesis wavs from ``training/sampling.py``."""
        d = os.path.join(self.ckpt_dir(project), "samples")
        if not os.path.isdir(d):
            return []
        return [os.path.join(d, e) for e in sorted(os.listdir(d))
                if e.endswith(".wav")]


def random_metadata_sample(metadata_csv: str, seed: Optional[int] = None):
    """(text, audio_path) of a random row — the UI's spot-check helper
    (`finetune_gradio.py:1420-1446`)."""
    import random as _random

    if not os.path.isfile(metadata_csv):
        return "", None
    rows = []
    base = os.path.dirname(metadata_csv)
    with open(metadata_csv, encoding="utf-8-sig") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) >= 2 and parts[0].strip():
                p = parts[0].strip()
                rows.append((parts[1].strip(),
                             p if os.path.isabs(p) else os.path.join(base, p)))
    if not rows:
        return "", None
    return _random.Random(seed).choice(rows)


def vocab_count(text: str) -> int:
    """Token count of a whitespace-separated symbol list (`:1290`)."""
    return len([t for t in text.split() if t])


def calculate_train(duration_json: str, batch_size_type: str = "frame",
                    num_warmup_updates: int = 100, finetune: bool = True,
                    hbm_gb: float = 16.0, n_chips: int = 1,
                    hop_length: int = 256, sampling_rate: int = 24000) -> dict:
    """Suggested hyperparameters from dataset statistics
    (`finetune_gradio.py:905-993`), with the JAX package's memory model: the
    reference scales the 38,400-frame budget by CUDA device memory; this one
    scales the JAX package's 36,864 frames per 16 GB by ``hbm_gb`` of memory
    per device times ``n_chips`` devices (its defaults are the JAX
    package's, kept so the two suggest the same settings)."""
    import json

    if not os.path.isfile(duration_json):
        raise FileNotFoundError(f"no duration.json at {duration_json} — prepare "
                                "the dataset first")
    with open(duration_json, encoding="utf-8") as f:
        durations = json.load(f)["duration"]
    total_samples = len(durations)
    total_duration = float(sum(durations))
    max_sample_frames = max(durations) * sampling_rate / hop_length

    if batch_size_type == "frame":
        # the JAX package's budget: 36,864 frames a step per 16 GB (9 x 4096
        # buckets), scaled linearly in memory per device
        batch = max(int(36864 * (hbm_gb * n_chips) / 16.0 / n_chips),
                    int(max_sample_frames))
        updates_per_epoch = total_duration / (
            batch * n_chips * hop_length / sampling_rate)
    elif batch_size_type == "sample":
        batch = max(int(200 / (total_duration / total_samples)), 1)
        updates_per_epoch = total_samples / (batch * n_chips)
    else:
        raise ValueError(f"batch_size_type {batch_size_type!r}")

    max_samples = min(64, max(int(total_samples * 0.25), 1)) \
        if total_samples < 64 else 64
    warmup = max(num_warmup_updates, int(total_samples * 0.05))
    epochs = max(int(1_200_000 / max(updates_per_epoch, 1e-9)), 1)
    return {
        "epochs": epochs,
        "learning_rate": 1e-5 if finetune else 7.5e-5,
        "batch_size_per_gpu": batch,
        "max_samples": max_samples,
        "num_warmup_updates": warmup,
        "total_samples": total_samples,
        "total_hours": total_duration / 3600.0,
    }


def settings_to_cli_args(project: str, settings: dict, data_root: str) -> list[str]:
    """The ``eraxvif5tts-torch-finetune`` argv a settings dict describes — the bridge
    from the UI form to ``TrainingProcess.start`` (reference assembles an
    ``accelerate launch ... train.py`` command line, `finetune_gradio.py:363-505`)."""
    s = {**DEFAULT_SETTINGS, **settings}
    args = [
        "finetune",  # subcommand dispatched by training/cli.py's __main__
        "--exp_name", str(s["exp_name"]),
        "--dataset_name", project,
        "--data-dir", data_root,
        "--learning_rate", str(s["learning_rate"]),
        "--batch_size_per_gpu", str(s["batch_size_per_gpu"]),
        "--batch_size_type", str(s["batch_size_type"]),
        "--max_samples", str(s["max_samples"]),
        "--grad_accumulation_steps", str(s["grad_accumulation_steps"]),
        "--max_grad_norm", str(s["max_grad_norm"]),
        "--epochs", str(s["epochs"]),
        "--num_warmup_updates", str(s["num_warmup_updates"]),
        "--save_per_updates", str(s["save_per_updates"]),
        "--keep_last_n_checkpoints", str(s["keep_last_n_checkpoints"]),
        "--last_per_updates", str(s["last_per_updates"]),
        "--tokenizer", str(s["tokenizer_type"]),
        "--logger", str(s["logger"]),
        "--compute_dtype", str(s["compute_dtype"]),
        # keep checkpoints inside the project tree: every other tab
        # (Test Model, samples, resume) reads {data_root}/{project}/ckpts,
        # while the CLI's default would be CWD-relative ckpts/{exp_name}
        "--checkpoint_dir", os.path.join(data_root, project, "ckpts"),
    ]
    if not s["finetune"]:
        args.append("--from-scratch")
    if s["file_checkpoint_train"]:
        args += ["--pretrain", str(s["file_checkpoint_train"])]
    if s["tokenizer_file"]:
        args += ["--tokenizer_path", str(s["tokenizer_file"])]
    return args
