"""Batched test-set inference across processes (port of
`eraxvif5tts_tpu/eval/eval_infer_batch.py`).

Parity with reference `src/f5_tts/eval/eval_infer_batch.py`: length-bucketed
prompt batches (one duration bucket per batch), prompts split across
processes (``accelerator.split_between_processes`` -> the rank's stride of
the list: ``torch.distributed``'s rank and world when a group is initialised),
per-utterance wav save, wall-clock RTF report.

Each batch runs ``wrapper.cfm.sample`` with one ``[bucket, n_mels]`` noise
draw shared by every row, each row at its own prompt and total length, then
vocodes the whole mel with ``wrapper.vocoder`` and cuts each row's
``[ref_len * hop : total_len * hop]``, as the JAX function does. The noise
comes from ``wrapper._draw_noise`` with a ``torch.Generator`` on the
wrapper's device re-seeded with ``seed`` for every batch (the JAX function
reuses ``jax.random.key(seed)`` for every batch); the streams differ from
``jax.random``'s, and tests hand the JAX draw in.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from eraxvif5tts_tpu_torch.audio.io import read_wav, write_wav
from eraxvif5tts_tpu_torch.eval.utils_eval import (
    get_inference_prompt,
    get_seedtts_testset_metainfo,
)
from eraxvif5tts_tpu_torch.infer.utils import pick_bucket
from eraxvif5tts_tpu_torch.infer.utils_infer import resolve_device
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from eraxvif5tts_tpu_torch.text.tokenizer import list_str_to_idx


def process_rank_and_count() -> tuple[int, int]:
    """(rank, world size) of the initialised ``torch.distributed`` group,
    else (0, 1): the counterpart of ``jax.process_index()`` /
    ``jax.process_count()``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def split_between_processes(items: list, process_index: Optional[int] = None,
                            process_count: Optional[int] = None) -> list:
    """This process's share of ``items``: every ``process_count``-th from
    ``process_index`` (both default to :func:`process_rank_and_count`)."""
    if process_index is None or process_count is None:
        process_index, process_count = process_rank_and_count()
    return items[process_index::process_count]


def wrapper_mel_fn(wrapper):
    """``wav [t] -> mel [n, d]`` numpy, the wrapper's frontend on its device,
    over the whole hops of ``wav``."""
    hop = wrapper.hop_length

    @torch.inference_mode()
    def mel_fn(wav: np.ndarray) -> np.ndarray:
        n = len(wav) // hop * hop
        x = torch.from_numpy(np.ascontiguousarray(wav[None, :n], np.float32)).to(wrapper.device)
        return wrapper.mel_spec(x).transpose(1, 2)[0, : n // hop].cpu().numpy()

    return mel_fn


@torch.inference_mode()
def run_eval_inference(
    wrapper,
    batches,
    output_dir: str,
    nfe_step: int = 32,
    cfg_strength: float = 2.0,
    sway_sampling_coef: float = -1.0,
    seed: int = 0,
    no_ref_audio: bool = False,
) -> dict:
    """Run all prompt batches through ``cfm.sample`` + vocoder; save wavs; report RTF.

    ``no_ref_audio`` is taken and unused, as in the JAX function (which
    passes nothing of it to the sampler)."""
    os.makedirs(output_dir, exist_ok=True)
    sr = wrapper.target_sample_rate
    hop = wrapper.hop_length
    dev = wrapper.device

    total_audio_sec = 0.0
    t0 = time.perf_counter()
    n_utts = 0
    for batch in batches:
        bucket = pick_bucket(int(batch.total_mel_lens.max()) + 1, wrapper.duration_buckets)
        text_bucket = pick_bucket(max(len(t) for t in batch.final_texts), wrapper.text_buckets)
        text_ids = list_str_to_idx(batch.final_texts, wrapper.vocab_char_map, pad_to=text_bucket)
        generator = torch.Generator(device=dev).manual_seed(seed)
        out = wrapper.cfm.sample(
            torch.from_numpy(batch.ref_mels).to(dev),
            torch.from_numpy(text_ids).long().to(dev),
            torch.from_numpy(batch.total_mel_lens).long().to(dev),
            torch.from_numpy(batch.ref_mel_lens).long().to(dev),
            noise=wrapper._draw_noise(generator, bucket),
            steps=nfe_step,
            cfg_strength=cfg_strength,
            sway_sampling_coef=sway_sampling_coef,
            max_duration=bucket,
        )
        waves = wrapper.vocoder(out.transpose(1, 2)).float().cpu().numpy()
        for i, utt in enumerate(batch.utts):
            start = int(batch.ref_mel_lens[i]) * hop
            end = int(batch.total_mel_lens[i]) * hop
            wave = waves[i, start:end]
            write_wav(os.path.join(output_dir, f"{utt}.wav"), wave, sr)
            total_audio_sec += len(wave) / sr
            n_utts += 1
    wall = time.perf_counter() - t0
    report = {
        "utterances": n_utts,
        "audio_seconds": round(total_audio_sec, 2),
        "wall_seconds": round(wall, 2),
        "rtf": round(total_audio_sec / max(wall, 1e-6), 3),
        "nfe_step": nfe_step,
    }
    with open(os.path.join(output_dir, "_eval_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="eraxvif5tts-torch-eval")
    p.add_argument("-n", "--model", default="F5TTS_v1_Base")
    p.add_argument("-p", "--ckpt_file", required=True)
    p.add_argument("-v", "--vocab_file", required=True)
    p.add_argument("-t", "--testset", required=True, help="seedtts metalst path")
    p.add_argument("-o", "--output_dir", default="eval_out")
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--cfg_strength", type=float, default=2.0)
    p.add_argument("--sway", type=float, default=-1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocoder_ckpt", default=None)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    wrapper = F5TTSWrapper(model_name=args.model, ckpt_path=args.ckpt_file,
                           vocab_file=args.vocab_file, vocoder_ckpt_path=args.vocoder_ckpt,
                           device=resolve_device(args.device))
    metainfo = split_between_processes(get_seedtts_testset_metainfo(args.testset))
    batches = get_inference_prompt(
        metainfo, mel_fn=wrapper_mel_fn(wrapper), load_wav=read_wav,
        tokenize=lambda t: convert_char_to_pinyin([t])[0],
    )
    report = run_eval_inference(
        wrapper, batches, args.output_dir, nfe_step=args.nfe_step,
        cfg_strength=args.cfg_strength, sway_sampling_coef=args.sway, seed=args.seed,
    )
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
