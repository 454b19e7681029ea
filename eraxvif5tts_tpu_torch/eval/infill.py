"""Offline infill quality battery: ``python -m eraxvif5tts_tpu_torch.eval infill``
(port of `eraxvif5tts_tpu/eval/infill.py`).

The trained-weights objective eval that works with zero egress (no Whisper /
UTMOS / ECAPA downloads): condition on the first half of each bundled real
recording, regenerate the second half from its transcript with the production
``cfm.sample``, and score the generated region against the ground-truth
recording — per (utterance, seed) cell, per arm (teacher / student /
random-null), with mean±sd aggregates. The arms compute in bf16 on the card
unless ``--cpu`` (fp32 parameters, as the JAX battery: kernels 1 and 2 in
bf16).

Role parity: the objective-eval harness of reference
`src/f5_tts/eval/eval_infer_batch.py:161-199` + `eval/utils_eval.py:305-418`,
with mel-domain proxies (gen-region mel L1, LTAS correlation) standing in for
WER/SIM since the external scorer models cannot be downloaded here.

Metrics per cell:
- ``infill_mel_l1``  — mean |gen - target| over the regenerated region
  (lower = better; ~2.0 is the target-magnitude scale, random weights sit
  near it).
- ``ltas_corr``      — Pearson correlation of the time-averaged log-mel
  spectrum (LTAS) of the full output vs the full recording (1.0 = perfect;
  the recording's own half-vs-half ceiling is reported alongside).

Seeds: a cell's noise is one ``[bucket, n_mels]`` draw of a
``torch.Generator`` seeded with ``7 + utt + 1000 * seed`` (the JAX battery's
``jax.random.key`` of the same number): the same scheme, another stream
(tests hand the JAX draw in through :func:`_cell_noise`). The random-null
arm is the port's default initialisation under ``torch.manual_seed(0)``, not
the JAX ``init_params``' draw.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

# a checkout of the reference F5-TTS repository, whose bundled recordings
# make the corpus (``--ref-root``; relative to the working directory)
REF_ROOT = "reference"
# Bundled REAL recordings with known transcripts (the reference ships exactly
# these three with text; the `multi/*.flac` voices have ref_text="" in
# `infer/examples/multi/story.toml` — transcripts unavailable offline).
CORPUS = [
    ("src/f5_tts/infer/examples/basic/basic_ref_en.wav",
     "Some call me nature, others call me mother nature."),
    ("src/f5_tts/infer/examples/basic/basic_ref_zh.wav",
     "对，这就是我，万人敬仰的太乙真人。"),
    ("src/infer/update_213000_ref.wav",
     "Thậm chí không ăn thì cũng có cảm giác rất là cứng bụng, chủ yếu là cái "
     "phần rốn trở lên. Em có cảm giác khó thở, và ngủ cũng không ngon, "
     "thường bị ợ hơi rất là nhiều"),
]


def load_corpus(mel_fn, sr_target: int, hop: int, root: str = REF_ROOT):
    """Rows ``{text, duration, mel_spec [n, n_mels]}`` from the bundled wavs;
    ``mel_fn(wav [1, t] float32 numpy)`` returns ``[1, n_mels, frames]``."""
    from eraxvif5tts_tpu_torch.audio.io import read_wav
    from eraxvif5tts_tpu_torch.audio.resample import resample

    rows = []
    for rel, text in CORPUS:
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            continue
        wav, sr = read_wav(path)
        wav = wav.mean(axis=0)
        if sr != sr_target:
            wav = resample(wav, sr, sr_target)
        n_frames = len(wav) // hop
        wav = wav[: n_frames * hop]
        mel = np.asarray(mel_fn(wav[None]))[0].T[:n_frames]  # [n, n_mels]
        rows.append({
            "text": text,
            "duration": n_frames * hop / sr_target,
            "mel_spec": mel.astype(np.float32),
        })
    if not rows:
        raise FileNotFoundError(f"no corpus wavs under {root}")
    return rows


def corpus_vocab(rows) -> dict[str, int]:
    """The char vocab `scripts/convergence_real.py` trains with: sorted chars
    of the corpus transcripts."""
    chars = sorted({c for r in rows for c in r["text"]})
    return {c: i for i, c in enumerate(chars)}


def ltas_corr(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    """Pearson corr of time-averaged log-mel spectra. mel_*: [n_mels, t]."""
    a, b = mel_a.mean(axis=1), mel_b.mean(axis=1)
    a, b = a - a.mean(), b - b.mean()
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


def _cell_key(utt_idx: int, seed: int, device="cpu") -> torch.Generator:
    """Seed scheme: seed 0 is ``7 + i`` (the JAX battery's ``key(7 + i)``,
    `scripts/synthesize_trained.py`); further seeds step by 1000."""
    return torch.Generator(device=device).manual_seed(7 + utt_idx + 1000 * seed)


def _cell_noise(utt_idx: int, seed: int, n_frames: int, n_mels: int, device) -> torch.Tensor:
    """A cell's ``[n_frames, n_mels]`` sampler noise, from :func:`_cell_key`."""
    return torch.randn((n_frames, n_mels), generator=_cell_key(utt_idx, seed, device),
                       device=device)


@torch.inference_mode()
def evaluate_arm(cfm, rows, vocab, seeds: int, steps: int,
                 cfg_strength: float = 2.0, arm: str = "arm",
                 save_dir: str | None = None) -> list[dict]:
    """One (utterance x seed) grid of seeded second-half infills, on the
    device of ``cfm``'s backbone."""
    from eraxvif5tts_tpu_torch.infer.utils import pick_bucket
    from eraxvif5tts_tpu_torch.text.tokenizer import list_str_to_idx

    dev = next(cfm.transformer.parameters()).device
    cells = []
    for i, r in enumerate(rows):
        total = r["mel_spec"].shape[0]
        ref_len = total // 2
        bucket = pick_bucket(total)
        text_ids = torch.from_numpy(list_str_to_idx([list(r["text"])], vocab)).long().to(dev)
        cond = torch.from_numpy(r["mel_spec"][None, :ref_len]).to(dev)
        tgt = r["mel_spec"][ref_len:].T  # [n_mels, gen]
        full = r["mel_spec"].T
        for s in range(seeds):
            mel_out = cfm.sample(
                cond, text_ids,
                torch.tensor([total], device=dev), torch.tensor([ref_len], device=dev),
                noise=_cell_noise(i, s, bucket, cfm.num_channels, dev),
                steps=steps, cfg_strength=cfg_strength, max_duration=bucket,
            )
            mel_np = mel_out[0, :total].float().cpu().numpy().T
            gen = mel_np[:, ref_len:]
            cell = {
                "arm": arm, "utt": i, "seed": s,
                "infill_mel_l1": round(
                    float(np.mean(np.abs(gen - tgt[:, : gen.shape[1]]))), 4),
                # gen-region LTAS is the discriminating spectral metric: the
                # full-mel variant is inflated by the pasted-back real prompt
                # (half the frames), so even random weights score ~0.97 there
                "ltas_corr_gen": round(
                    ltas_corr(gen, tgt[:, : gen.shape[1]]), 4),
                "ltas_corr_full": round(ltas_corr(mel_np, full), 4),
            }
            if save_dir is not None and s == 0:
                os.makedirs(save_dir, exist_ok=True)
                np.save(os.path.join(save_dir, f"{arm}_utt{i}.npy"), mel_np)
            cells.append(cell)
            print(json.dumps(cell), flush=True)
    return cells


def _mean_sd(vals) -> dict:
    v = np.asarray(vals, np.float64)
    return {"mean": round(float(v.mean()), 4),
            "sd": round(float(v.std(ddof=1)) if len(v) > 1 else 0.0, 4),
            "n": int(len(v))}


def _summarize(cells: list[dict]) -> dict:
    return {
        "infill_mel_l1": _mean_sd([c["infill_mel_l1"] for c in cells]),
        "ltas_corr_gen": _mean_sd([c["ltas_corr_gen"] for c in cells]),
        "ltas_corr_full": _mean_sd([c["ltas_corr_full"] for c in cells]),
    }


def _load_arm_params(ckpt: str, preset_cfg, vocab, compute_dtype, device="cuda"):
    """Import a reference-schema checkpoint into a CFM on ``device``
    (parameters fp32, computing in ``compute_dtype``); depth inferred so
    pruned/distilled students load through the same path. Returns
    (cfm, depth)."""
    from eraxvif5tts_tpu_torch.compression.convert import (
        infer_depth,
        infer_text_num_embeds,
        reference_backbone_state_dict,
    )
    from eraxvif5tts_tpu_torch.models import build_backbone
    from eraxvif5tts_tpu_torch.models.cfm import CFM

    sd = reference_backbone_state_dict(ckpt, use_ema=True)
    depth = infer_depth(sd)
    n_text = infer_text_num_embeds(sd)
    if n_text != len(vocab):
        raise ValueError(
            f"checkpoint text vocab {n_text} != corpus vocab {len(vocab)} — was it "
            "exported by convergence_real.py / distill_real.py on the same corpus?")
    cfg = dataclasses.replace(
        preset_cfg, arch=dataclasses.replace(preset_cfg.arch, depth=depth))
    with torch.device(device):  # built where it runs; `.to` moves buffers made on the host
        transformer = build_backbone(cfg, text_num_embeds=len(vocab),
                                     compute_dtype=compute_dtype)
    transformer.load_state_dict(sd, strict=True)
    return CFM(transformer.to(device).eval()), depth


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m eraxvif5tts_tpu_torch.eval infill",
        description="Seeded infill battery over the bundled real recordings")
    ap.add_argument("--teacher", required=True,
                    help="trained full-model checkpoint (reference schema)")
    ap.add_argument("--student", default=None,
                    help="optional distilled/pruned checkpoint (depth inferred)")
    ap.add_argument("--no-null", action="store_true",
                    help="skip the random-weights null arm")
    ap.add_argument("--seeds", type=int, default=5,
                    help="seeds per utterance (3 utts x 5 = 15 cells/arm)")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--cfg-strength", type=float, default=2.0)
    ap.add_argument("--preset", default="F5TTS_v1_Base")
    ap.add_argument("--out-dir", default="benchmarks/artifacts/infill_eval")
    ap.add_argument("--ref-root", default=REF_ROOT,
                    help="checkout of the reference repository (the corpus wavs)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    # arch overrides over the preset (smoke-testing the battery with tiny
    # checkpoints on CPU; depth always comes from the checkpoint itself)
    ap.add_argument("--dim", type=int, default=None)
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--dim-head", type=int, default=None)
    ap.add_argument("--ff-mult", type=int, default=None)
    ap.add_argument("--text-dim", type=int, default=None)
    ap.add_argument("--conv-layers", type=int, default=None)
    args = ap.parse_args(argv)

    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.models import build_backbone
    from eraxvif5tts_tpu_torch.models.cfm import CFM
    from eraxvif5tts_tpu_torch.ops.stft import MelSpectrogram

    dev = torch.device("cpu" if args.cpu else "cuda")
    cfg = PRESETS[args.preset]
    overrides = {k: getattr(args, k) for k in
                 ("dim", "heads", "dim_head", "ff_mult", "text_dim",
                  "conv_layers") if getattr(args, k) is not None}
    if overrides:
        cfg = dataclasses.replace(
            cfg, arch=dataclasses.replace(cfg.arch, **overrides))
    mel_cfg = cfg.mel_spec
    mel_spec = MelSpectrogram(
        n_fft=mel_cfg.n_fft, hop_length=mel_cfg.hop_length,
        win_length=mel_cfg.win_length, n_mel_channels=mel_cfg.n_mel_channels,
        target_sample_rate=mel_cfg.target_sample_rate)

    def mel_fn(wav: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(dev)
        return mel_spec(x).cpu().numpy()

    rows = load_corpus(mel_fn, mel_cfg.target_sample_rate, mel_cfg.hop_length,
                       root=args.ref_root)
    vocab = corpus_vocab(rows)

    arms: dict[str, list[dict]] = {}
    depths: dict[str, int] = {}

    cfm_t, depths["teacher"] = _load_arm_params(args.teacher, cfg, vocab, torch.bfloat16, dev)
    arms["teacher"] = evaluate_arm(
        cfm_t, rows, vocab, args.seeds, args.steps,
        args.cfg_strength, arm="teacher", save_dir=args.out_dir)

    if args.student:
        cfm_s, depths["student"] = _load_arm_params(args.student, cfg, vocab,
                                                    torch.bfloat16, dev)
        arms["student"] = evaluate_arm(
            cfm_s, rows, vocab, args.seeds, args.steps,
            args.cfg_strength, arm="student", save_dir=args.out_dir)

    if not args.no_null:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            null_tf = build_backbone(cfg, text_num_embeds=len(vocab),
                                     compute_dtype=torch.bfloat16)
        null_cfm = CFM(null_tf.to(dev).eval())
        depths["random_null"] = cfg.arch.depth
        arms["random_null"] = evaluate_arm(
            null_cfm, rows, vocab, args.seeds, args.steps,
            args.cfg_strength, arm="random_null", save_dir=args.out_dir)

    # LTAS ceiling: the recording's own first half vs second half
    ceiling = float(np.mean([
        ltas_corr(r["mel_spec"].T[:, : r["mel_spec"].shape[0] // 2],
                  r["mel_spec"].T[:, r["mel_spec"].shape[0] // 2:])
        for r in rows]))

    report = {
        "teacher_ckpt": args.teacher,
        "student_ckpt": args.student,
        "steps": args.steps,
        "seeds": args.seeds,
        "n_utterances": len(rows),
        "arm_depths": depths,
        "ltas_ceiling_recording_halves": round(ceiling, 4),
        "summary": {arm: _summarize(cells) for arm, cells in arms.items()},
        "cells": [c for cells in arms.values() for c in cells],
    }
    os.makedirs(args.out_dir, exist_ok=True)
    out_path = os.path.join(args.out_dir, "report.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({
        "metric": "infill_eval_teacher_mel_l1",
        "value": report["summary"]["teacher"]["infill_mel_l1"]["mean"],
        "sd": report["summary"]["teacher"]["infill_mel_l1"]["sd"],
        "cells_per_arm": len(arms["teacher"]),
        "artifact": out_path,
    }))
    return report


if __name__ == "__main__":
    run()
