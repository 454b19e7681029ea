"""Objective-metric entry points: WER / SIM / UTMOS over a directory of generated
wavs (port of `eraxvif5tts_tpu/eval/scorers.py`; reference
`eval_seedtts_testset.py`, `eval_librispeech_test_clean.py`, `eval_utmos.py`).

External scoring models (Whisper/paraformer ASR, WavLM ECAPA-TDNN, UTMOS) are
pluggable and gated: in zero-egress environments pass local models or use the
jsonl-producing harness with your own scorer.
"""

from __future__ import annotations

import json
import os

import numpy as np

from eraxvif5tts_tpu_torch.eval.utils_eval import _ordered_pool_map, run_asr_wer, run_sim


def eval_wer_dir(gen_wav_dir: str, metainfo, language: str = "en",
                 out_jsonl: str | None = None, asr_fn=None,
                 num_workers: int = 4) -> dict:
    """WER over generated wavs matched to truth texts; writes jsonl + summary.
    ``num_workers`` threads score in parallel (reference uses a per-GPU
    ``mp.Pool``, `eval_seedtts_testset.py:62-70`)."""
    pairs = []
    for utt, _prompt_text, _prompt_wav, gt_text, _gt_wav in metainfo:
        path = os.path.join(gen_wav_dir, f"{utt}.wav")
        if os.path.isfile(path):
            pairs.append((path, gt_text))
    results = run_asr_wer(pairs, language=language, asr_fn=asr_fn,
                          num_workers=num_workers)
    wers = [r["wer"] for r in results]
    summary = {"n": len(wers), "wer_mean": float(np.mean(wers)) if wers else None}
    if out_jsonl:
        with open(out_jsonl, "w", encoding="utf-8") as f:
            for r in results:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
            f.write(json.dumps(summary) + "\n")
    return summary


def eval_sim_dir(gen_wav_dir: str, metainfo, embed_fn,
                 out_jsonl: str | None = None, num_workers: int = 4) -> dict:
    """Speaker-similarity over generated wavs vs their prompts (threaded,
    prompt embeddings cached per distinct prompt)."""
    pairs = []
    for utt, _pt, prompt_wav, _gt, _gw in metainfo:
        path = os.path.join(gen_wav_dir, f"{utt}.wav")
        if os.path.isfile(path):
            pairs.append((path, prompt_wav))
    results = run_sim(pairs, embed_fn, num_workers=num_workers)
    sims = [r["sim"] for r in results]
    summary = {"n": len(sims), "sim_mean": float(np.mean(sims)) if sims else None}
    if out_jsonl:
        with open(out_jsonl, "w", encoding="utf-8") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps(summary) + "\n")
    return summary


def default_speaker_embed_fn(ckpt_path: str | None = None, device="cuda"):
    """ECAPA-TDNN speaker embedder (reference `eval/ecapa_tdnn.py` +
    `utils_eval.py:379-418`).

    ``ckpt_path`` (or the ``ECAPA_CKPT`` environment variable) points at the
    UniSpeech WavLM-ECAPA checkpoint; it loads strict into the port's ECAPA
    head, which scores over log-fbank features on ``device``. Without a
    checkpoint this raises — random weights would produce meaningless SIM
    numbers silently."""
    from eraxvif5tts_tpu_torch.eval.ecapa_tdnn import make_mel_embed_fn

    ckpt_path = ckpt_path or os.environ.get("ECAPA_CKPT")
    if not ckpt_path:
        raise FileNotFoundError(
            "no speaker-embedder checkpoint: pass ckpt_path=..., set ECAPA_CKPT, "
            "or pass your own embed_fn (any callable wav_path -> np.ndarray)"
        )
    return make_mel_embed_fn(ckpt_path=ckpt_path, device=device)


def eval_utmos_dir(gen_wav_dir: str, out_jsonl: str | None = None,
                   utmos_fn=None) -> dict:
    """UTMOS naturalness MOS (reference `eval_utmos.py:18` uses
    ``torch.hub tarepan/SpeechMOS utmos22_strong``)."""
    if utmos_fn is None:
        import torch

        predictor = torch.hub.load("tarepan/SpeechMOS:v1.2.0", "utmos22_strong",
                                   trust_repo=True)

        from eraxvif5tts_tpu_torch.audio.io import read_wav

        def utmos_fn(path):
            wav, sr = read_wav(path)
            score = predictor(torch.from_numpy(wav.mean(axis=0))[None], sr)
            return float(score)

    names = [n for n in sorted(os.listdir(gen_wav_dir)) if n.endswith(".wav")]
    scores = _ordered_pool_map(
        lambda name: utmos_fn(os.path.join(gen_wav_dir, name)), names, num_workers=4
    )
    lines = [{"wav": n, "utmos": s} for n, s in zip(names, scores)]
    summary = {"n": len(scores), "utmos_mean": float(np.mean(scores)) if scores else None}
    if out_jsonl:
        with open(out_jsonl, "w", encoding="utf-8") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
            f.write(json.dumps(summary) + "\n")
    return summary
