"""Inference CLI with TOML config merge and multi-voice ``[voice]`` tags, on the
port's wrapper (port of `eraxvif5tts_tpu/infer/infer_cli.py`; reference
`src/f5_tts/infer/infer_cli.py`): argparse options override a TOML config;
``gen_text`` may contain ``[voice_name]`` tags switching between configured
voices; chunk wavs optionally saved; silence removal.

It runs on the card (``--device`` defaults to ``cuda``; ``cuda:N`` and
``cpu`` are accepted, ``tpu`` is not). The bundled example configs and clips
are read as data files from `eraxvif5tts_tpu/infer/examples/`:

    python -m eraxvif5tts_tpu_torch.infer.infer_cli \
        -c eraxvif5tts_tpu/infer/examples/basic/basic.toml -p model.pt -v vocab.txt
"""

from __future__ import annotations

import argparse
import os
import re
import tomllib
from pathlib import Path

import numpy as np

from eraxvif5tts_tpu_torch.audio.io import write_wav
from eraxvif5tts_tpu_torch.infer.utils_infer import (
    compute_dtype_for,
    infer_process,
    preprocess_ref_audio_text,
    remove_silence_for_generated_wav,
    resolve_device,
)
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="eraxvif5tts-torch-infer",
                                description="F5-TTS batch inference on the PyTorch/CUDA port")
    p.add_argument("-c", "--config", default=None, help="TOML config path")
    p.add_argument("-m", "--model", default=None)
    p.add_argument("-mc", "--model_cfg", default=None,
                   help="model config yaml path (overrides the preset's arch)")
    p.add_argument("-p", "--ckpt_file", default=None)
    p.add_argument("-v", "--vocab_file", default=None)
    p.add_argument("-r", "--ref_audio", default=None)
    p.add_argument("-s", "--ref_text", default=None)
    p.add_argument("-t", "--gen_text", default=None)
    p.add_argument("-f", "--gen_file", default=None)
    p.add_argument("-o", "--output_dir", default=None)
    p.add_argument("-w", "--output_file", default=None)
    p.add_argument("--save_chunk", action="store_true")
    p.add_argument("--remove_silence", action="store_true")
    p.add_argument("--vocoder_ckpt", default=None)
    p.add_argument("--vocoder_name", default=None, choices=("vocos", "bigvgan"))
    p.add_argument("--target_rms", type=float, default=None)
    p.add_argument("--device", default=None,
                   help="'cuda' (default), 'cuda:N' or 'cpu'; 'tpu' is rejected")
    p.add_argument("--nfe_step", type=int, default=None)
    p.add_argument("--cfg_strength", type=float, default=None)
    p.add_argument("--sway_sampling_coef", type=float, default=None)
    p.add_argument("--speed", type=float, default=None)
    p.add_argument("--fix_duration", type=float, default=None)
    p.add_argument("--cross_fade_duration", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    return p.parse_args(argv)


def merge_config(args) -> dict:
    """TOML defaults, CLI overrides (`infer_cli.py:176-211`)."""
    config: dict = {}
    if args.config:
        with open(args.config, "rb") as f:
            config = tomllib.load(f)
    for key in ("model", "model_cfg", "ckpt_file", "vocab_file", "ref_audio",
                "ref_text", "gen_text", "gen_file", "output_dir", "output_file",
                "nfe_step", "cfg_strength", "sway_sampling_coef", "speed",
                "fix_duration", "cross_fade_duration", "vocoder_ckpt",
                "vocoder_name", "target_rms", "device", "seed"):
        val = getattr(args, key, None)
        if val is not None:
            config[key] = val
    config.setdefault("model", "F5TTS_v1_Base")
    config.setdefault("output_dir", "tests")
    config.setdefault("output_file", "infer_cli_out.wav")
    config.setdefault("remove_silence", args.remove_silence)
    config.setdefault("save_chunk", args.save_chunk)
    return config


_VOICE_SPLIT = re.compile(r"(?=\[\w+\])")
_VOICE_TAG = re.compile(r"\[(\w+)\]")

# The repository root: bundled example configs name their clips as
# ``eraxvif5tts_tpu/infer/examples/...`` and resolve here from any CWD.
_PKG_ROOT = Path(__file__).resolve().parents[2]


def resolve_example_path(path: str) -> str:
    """Remap bundled-example paths to the repository's examples directory.

    Paths that exist relative to CWD (or are absolute) pass through untouched;
    a missing path that points inside ``eraxvif5tts_tpu/infer/examples/`` is
    retried against the repository root so `-c .../basic.toml` works from any
    CWD.
    """
    if not path or os.path.exists(path):
        return path
    norm = path.replace("\\", "/")
    if "eraxvif5tts_tpu/infer/examples/" in norm:
        candidate = _PKG_ROOT / norm[norm.index("eraxvif5tts_tpu/"):]
        if candidate.exists():
            return str(candidate)
    return path


def split_voice_chunks(gen_text: str) -> list[tuple[str, str]]:
    """-> [(voice_name, text)] with 'main' default (`infer_cli.py:306-321`)."""
    out = []
    for chunk in _VOICE_SPLIT.split(gen_text):
        if not chunk.strip():
            continue
        m = _VOICE_TAG.match(chunk)
        voice = m.group(1) if m else "main"
        out.append((voice, _VOICE_TAG.sub("", chunk).strip()))
    return out


def run(config: dict, wrapper: F5TTSWrapper | None = None) -> str:
    gen_text = config.get("gen_text")
    if config.get("gen_file"):
        gen_text = Path(resolve_example_path(config["gen_file"])).read_text(encoding="utf-8")
    assert gen_text, "gen_text or gen_file required"

    device = resolve_device(config.get("device"))

    if wrapper is not None:
        # Constructor-only knobs cannot retroactively reconfigure a pre-built
        # wrapper — reject loudly instead of silently ignoring them.
        constructor_only = ("model_cfg", "ckpt_file", "vocab_file",
                            "vocoder_ckpt", "vocoder_name", "target_rms")
        ignored = [k for k in constructor_only if config.get(k) is not None]
        if ignored:
            raise ValueError(
                f"flags {ignored} configure the wrapper at construction and "
                "cannot apply to a pre-built wrapper instance — drop them or "
                "let run() build the wrapper itself")
        if config.get("device") is not None and device != wrapper.device:
            raise ValueError(f"--device {config['device']!r}: the pre-built wrapper is on "
                             f"{wrapper.device}")
    if wrapper is None:
        wrapper_kwargs = {}
        if config.get("model_cfg"):
            from eraxvif5tts_tpu_torch.configs import load_model_config

            wrapper_kwargs["model_cfg"] = load_model_config(
                resolve_example_path(config["model_cfg"]))
        if config.get("target_rms") is not None:
            wrapper_kwargs["target_rms"] = float(config["target_rms"])
        wrapper = F5TTSWrapper(
            model_name=config["model"],
            ckpt_path=config.get("ckpt_file"),
            vocab_file=config.get("vocab_file"),
            vocoder_ckpt_path=config.get("vocoder_ckpt"),
            vocoder_name=config.get("vocoder_name"),
            device=device,
            compute_dtype=compute_dtype_for(device),
            **wrapper_kwargs,
        )
    print(f"{config['model']} on {wrapper.device} ({wrapper.compute_dtype})")

    voices = {"main": {"ref_audio": config["ref_audio"], "ref_text": config.get("ref_text", "")}}
    voices.update(config.get("voices", {}))
    for name, voice in voices.items():
        voice["ref_audio"], voice["ref_text"] = preprocess_ref_audio_text(
            resolve_example_path(voice["ref_audio"]), voice.get("ref_text", "")
        )

    # target_rms is constructor-only (it scales the reference prompt at
    # preprocess time via the wrapper) — not a per-call sampling knob.
    sample_kwargs = {
        k: config[k]
        for k in ("nfe_step", "cfg_strength", "sway_sampling_coef", "speed",
                  "fix_duration", "cross_fade_duration", "seed")
        if k in config
    }

    segments = []
    sr = wrapper.target_sample_rate
    chunk_dir = os.path.join(config["output_dir"],
                             Path(config["output_file"]).stem + "_chunks")
    for i, (voice, text) in enumerate(split_voice_chunks(gen_text)):
        if voice not in voices:
            print(f"Voice {voice!r} not found, using main.")
            voice = "main"
        wave, sr, _spec = infer_process(
            voices[voice]["ref_audio"], voices[voice]["ref_text"], text, wrapper,
            **sample_kwargs,
        )
        segments.append(wave)
        if config.get("save_chunk"):
            os.makedirs(chunk_dir, exist_ok=True)
            stem = text[:200] + " ... " if len(text) > 200 else text
            write_wav(os.path.join(chunk_dir, f"{i}_{stem}.wav"), wave, sr)

    final = np.concatenate(segments) if segments else np.zeros(0, np.float32)
    os.makedirs(config["output_dir"], exist_ok=True)
    wave_path = os.path.join(config["output_dir"], config["output_file"])
    write_wav(wave_path, final, sr)
    if config.get("remove_silence"):
        remove_silence_for_generated_wav(wave_path)
    print(wave_path)
    return wave_path


def main(argv=None):
    args = parse_args(argv)
    run(merge_config(args))


if __name__ == "__main__":
    main()
