"""Speech editing: regenerate selected time spans of an utterance (port of
`eraxvif5tts_tpu/infer/speech_edit.py`; reference
`src/f5_tts/infer/speech_edit.py:137-184`).

The edit regions are zeroed in the conditioning audio and left out of the
prompt mask through ``CFM.sample``'s ``edit_mask`` at hop resolution, so the
sampler re-synthesizes only those spans and keeps the rest of the clip as a
fixed prompt. The attention still sees every frame up to the clip's end (the
key mask is the duration prefix), as in the JAX package.

    python -m eraxvif5tts_tpu_torch.infer.speech_edit -p model.pt -v vocab.txt \
        -a clip.wav --original_text "..." --target_text "..." --spans 1.2:1.9
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from eraxvif5tts_tpu_torch.infer.utils import pick_bucket
from eraxvif5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from eraxvif5tts_tpu_torch.text.tokenizer import list_str_to_idx


def edit_inputs(audio: np.ndarray, edit_spans_seconds: Sequence[tuple[float, float]],
                fix_durations_seconds: Sequence[float] | None, sr: int,
                hop: int) -> tuple[np.ndarray, np.ndarray]:
    """The clip with each span replaced by zeros (``fix_durations_seconds``
    resizes them) cut to whole frames, and its frame mask (True = kept
    frame). Spans are clamped to the clip and the previous span's end; an
    empty one raises."""
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    clip_seconds = len(audio) / sr
    spans: list[tuple[float, float]] = []
    prev_end = 0.0
    for start, end in edit_spans_seconds:
        start, end = max(start, prev_end), min(end, clip_seconds)
        if end <= start:
            raise ValueError(
                f"edit span ({start:.3f}, {end:.3f}) is empty after clamping to "
                f"the {clip_seconds:.3f}s clip and the previous span's end "
                f"({prev_end:.3f}); spans must be ascending, non-overlapping and "
                "inside the clip"
            )
        spans.append((start, end))
        prev_end = end

    parts: list[np.ndarray] = []
    edit_mask_parts: list[np.ndarray] = []
    offset = 0.0
    for i, (start, end) in enumerate(spans):
        fixed = fix_durations_seconds[i] if fix_durations_seconds else end - start
        keep = audio[int(offset * sr): int(start * sr)]
        parts.append(keep)
        edit_mask_parts.append(np.ones(len(keep) // hop + 1, bool))
        span_frames = int(fixed * sr / hop)
        parts.append(np.zeros(span_frames * hop, np.float32))
        edit_mask_parts.append(np.zeros(span_frames, bool))
        offset = end
    tail = audio[int(offset * sr):]
    parts.append(tail)
    edit_mask_parts.append(np.ones(len(tail) // hop + 1, bool))

    wave = np.concatenate(parts)
    n_frames = len(wave) // hop
    return wave[: n_frames * hop], np.concatenate(edit_mask_parts)[:n_frames]


@torch.inference_mode()
def edit_speech(
    wrapper,
    audio: np.ndarray,  # [t] float at target sample rate
    original_text: str,
    target_text: str,
    edit_spans_seconds: Sequence[tuple[float, float]],
    fix_durations_seconds: Sequence[float] | None = None,
    nfe_step: int = 32,
    cfg_strength: float = 2.0,
    sway_sampling_coef: float = -1.0,
    seed: int | None = None,
    use_pinyin: bool = True,
    return_mel: bool = False,
) -> np.ndarray | tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Regenerate ``edit_spans_seconds`` of ``audio`` to match ``target_text``
    with the port's :class:`~eraxvif5tts_tpu_torch.infer.wrapper.F5TTSWrapper`.

    ``fix_durations_seconds`` optionally resizes each edited span (the reference
    offsets the timeline accordingly, `speech_edit.py:137-158`).
    ``return_mel=True`` returns a 3-tuple ``(wave, mel [n_mels, n_frames],
    edit_mask [n_frames])`` instead — the model's raw output plus the frame
    mask: True = kept prompt frame, False = regenerated frame. The sampler's
    noise is ``wrapper._draw_noise`` of a generator seeded with ``seed``
    (0 when None), one ``[bucket, n_mels]`` draw.
    """
    sr = wrapper.target_sample_rate
    hop = wrapper.hop_length
    dev = wrapper.device
    wave, edit_mask = edit_inputs(audio, edit_spans_seconds, fix_durations_seconds, sr, hop)
    n_frames = len(wave) // hop

    mel = wrapper.mel_spec(torch.from_numpy(wave[None]).to(dev))
    mel = mel.transpose(1, 2)[:, :n_frames]

    tokens = convert_char_to_pinyin([target_text]) if use_pinyin else [list(target_text)]
    bucket = pick_bucket(n_frames + 1, wrapper.duration_buckets)
    text_ids = list_str_to_idx(tokens, wrapper.vocab_char_map,
                               pad_to=pick_bucket(len(tokens[0]), wrapper.text_buckets))

    generator = torch.Generator(device=dev).manual_seed(seed if seed is not None else 0)
    frames = torch.tensor([n_frames], device=dev)
    out = wrapper.cfm.sample(
        mel, torch.from_numpy(text_ids).to(dev, torch.long), frames, frames,
        noise=wrapper._draw_noise(generator, bucket), steps=nfe_step,
        cfg_strength=cfg_strength, sway_sampling_coef=sway_sampling_coef,
        max_duration=bucket, edit_mask=torch.from_numpy(edit_mask[None]).to(dev))
    out_wave = wrapper.vocoder(out.transpose(1, 2))
    wave_np = out_wave[0, : n_frames * hop].float().cpu().numpy()
    if return_mel:
        return wave_np, out[0, :n_frames].T.cpu().numpy(), edit_mask
    return wave_np


def parse_spans(text: str) -> list[tuple[float, float]]:
    """``"1.5:2.7,4.0:4.8"`` -> [(1.5, 2.7), (4.0, 4.8)] (CLI span syntax)."""
    spans = []
    for piece in text.split(","):
        start, _, end = piece.partition(":")
        if not _:
            raise ValueError(f"span {piece!r} must be start:end seconds")
        spans.append((float(start), float(end)))
    return spans


def main(argv=None):
    """CLI for the reference's hardcoded edit script (its clip, texts and
    spans are module constants there; here they are flags). Runs on the card
    unless ``--device cpu``."""
    import argparse
    import os

    from eraxvif5tts_tpu_torch.audio.io import read_wav, write_wav
    from eraxvif5tts_tpu_torch.audio.resample import resample
    from eraxvif5tts_tpu_torch.infer.utils_infer import compute_dtype_for, resolve_device
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    p = argparse.ArgumentParser(prog="eraxvif5tts-torch-speech-edit")
    p.add_argument("-m", "--model", default="F5TTS_v1_Base")
    p.add_argument("-p", "--ckpt_file", default=None)
    p.add_argument("-v", "--vocab_file", default=None)
    p.add_argument("--vocoder_ckpt", default=None)
    p.add_argument("-a", "--audio", required=True, help="clip to edit (wav)")
    p.add_argument("--original_text", required=True)
    p.add_argument("--target_text", required=True)
    p.add_argument("--spans", required=True,
                   help='edit spans in seconds: "start:end[,start:end...]"')
    p.add_argument("--fix_durations", default=None,
                   help="comma-separated replacement span lengths in seconds")
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--cfg_strength", type=float, default=2.0)
    p.add_argument("--sway_sampling_coef", type=float, default=-1.0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--no_pinyin", action="store_true")
    p.add_argument("--device", default=None, help="'cuda' (default), 'cuda:N' or 'cpu'")
    p.add_argument("-o", "--output", default="tests/speech_edit_out.wav")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    wrapper = F5TTSWrapper(model_name=args.model, ckpt_path=args.ckpt_file,
                           vocab_file=args.vocab_file, vocoder_ckpt_path=args.vocoder_ckpt,
                           device=dev, compute_dtype=compute_dtype_for(dev))
    wave, sr = read_wav(args.audio)
    # downmix before any reshape: a stereo clip flattened by edit_speech would
    # concatenate both channels and double the timeline under the span math
    wave = wave.mean(axis=0)
    if sr != wrapper.target_sample_rate:
        wave = resample(wave, sr, wrapper.target_sample_rate)
    fixes = ([float(x) for x in args.fix_durations.split(",")]
             if args.fix_durations else None)
    out = edit_speech(
        wrapper, wave, args.original_text, args.target_text,
        parse_spans(args.spans), fix_durations_seconds=fixes,
        nfe_step=args.nfe_step, cfg_strength=args.cfg_strength,
        sway_sampling_coef=args.sway_sampling_coef, seed=args.seed,
        use_pinyin=not args.no_pinyin,
    )
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    write_wav(args.output, out, wrapper.target_sample_rate)
    print(args.output)
    return args.output


if __name__ == "__main__":
    main()
