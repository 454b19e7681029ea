"""Per-save smoke-test sample synthesis during training (port of
`eraxvif5tts_tpu/training/sampling.py`).

The reference synthesizes wavs from fixed reference prompts at every
checkpoint save (`trainer.py:397-515, 1387-1419`): listening is its test
strategy. ``make_sample_fn`` builds the ``sample_fn(state, step)`` hook the
trainer runs after each save: it samples with the EMA weights (or the live
ones) at a low NFE, writes the mel as ``.npy`` always, and a wav through a
vocoder when one is given, else a Griffin-Lim ``.gl.wav``.

The sample runs on a serving copy of the backbone, made at the first save:
its parameters in the training compute dtype (bf16 on the card: the serving
attention and the fused FF projection, as the wrapper serves), eval mode,
no gradient; each save copies the EMA weights (or the live ones) into it, so
the training state is untouched. The noise of update ``step`` is
``noise_fn(step, frames, n_mels)``: by default a normal draw from a CPU
``torch.Generator`` seeded by the update (tests pass the JAX draw in).
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from eraxvif5tts_tpu_torch.infer.utils import byte_ratio_duration, pick_bucket
from eraxvif5tts_tpu_torch.text.tokenizer import list_str_to_idx


def default_noise(step: int, frames: int, n_mels: int) -> torch.Tensor:
    """The sample's ``[frames, n_mels]`` noise for update ``step``."""
    g = torch.Generator().manual_seed(step)
    return torch.randn((frames, n_mels), generator=g)


def make_sample_fn(
    cfm,
    vocab_char_map: dict[str, int],
    prompts: Sequence[dict],
    out_dir: str,
    vocoder=None,
    steps: int = 16,
    tokenize: Optional[Callable] = None,
    use_ema: bool = True,
    sample_rate: int = 24000,
    hop_length: int = 256,
    noise_fn: Callable[[int, int, int], torch.Tensor] = default_noise,
) -> Callable:
    """``prompts``: dicts with ``ref_mel`` ([n, n_mels] float array), ``ref_text``,
    ``gen_text``; ``vocoder``: a module taking ``[1, n_mels, frames]`` to a
    wave (Vocos). Returns ``sample_fn(state, step)``, which returns the paths
    it wrote."""

    copies: list = []

    def sample_fn(state, step: int) -> list[str]:
        os.makedirs(out_dir, exist_ok=True)
        if not copies:
            copies.append(serving_copy(state.model))
        net = copies[0]
        weights = state.ema_params if use_ema else state.params
        with torch.no_grad():
            for name, p in net.named_parameters():
                p.copy_(weights[name])
        sampler = type(cfm)(net)
        device = next(net.parameters()).device
        written = []
        for i, prompt in enumerate(prompts):
            ref_mel = np.asarray(prompt["ref_mel"], np.float32)
            ref_text, gen_text = prompt["ref_text"], prompt["gen_text"]
            full_text = ref_text + " " + gen_text
            toks = tokenize(full_text) if tokenize else list(full_text)
            ids = torch.from_numpy(list_str_to_idx([toks], vocab_char_map)).to(device)
            ref_len = ref_mel.shape[0]
            duration = byte_ratio_duration(ref_len, ref_text, gen_text, speed=1.0,
                                           hop_length=hop_length, sample_rate=sample_rate)
            max_dur = pick_bucket(duration)
            n_mels = ref_mel.shape[1]
            cond = torch.from_numpy(ref_mel[:max_dur])[None].to(device)
            mel = sampler.sample(
                cond, ids, torch.tensor([duration], device=device),
                torch.tensor([min(ref_len, max_dur)], device=device),
                noise_fn(step, max_dur, n_mels), steps=steps, max_duration=max_dur)
            mel_np = mel[0, min(ref_len, max_dur):duration].float().cpu().numpy()
            base = os.path.join(out_dir, f"update_{step}_{i}")
            np.save(base + ".npy", mel_np)
            written.append(base + ".npy")
            written.append(_write_audio(base, mel_np, vocoder, device, sample_rate,
                                        hop_length))
        return written

    return sample_fn


def _write_audio(base: str, mel_np: np.ndarray, vocoder, device, sample_rate: int,
                 hop_length: int) -> str:
    from eraxvif5tts_tpu_torch.audio.io import write_wav

    if vocoder is not None:
        with torch.inference_mode():
            wav = vocoder(torch.from_numpy(mel_np.T)[None].to(device))[0]
        write_wav(base + ".wav", wav.float().cpu().numpy(), sample_rate)
        return base + ".wav"
    # no vocoder: Griffin-Lim inversion still yields an audible smoke sample
    from eraxvif5tts_tpu_torch.audio.griffin_lim import griffin_lim_mel

    wav = griffin_lim_mel(mel_np.T, n_iter=32, hop_length=hop_length, sample_rate=sample_rate)
    write_wav(base + ".gl.wav", wav, sample_rate)
    return base + ".gl.wav"


def serving_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of the training backbone ``model`` for sampling: its parameters
    cast to its compute dtype (which they then set), eval mode, no
    gradient."""
    net = copy.deepcopy(model)
    dtype = model.dtype
    net.compute_dtype = None
    return net.to(dtype).eval().requires_grad_(False)


def prompts_from_dataset(dataset, count: int = 1) -> list[dict]:
    """Fixed reference prompts drawn from the head of the dataset: the first half of
    each sample's mel is the prompt, the sample's own text is re-generated (the
    reference's in-batch smoke sample, `trainer.py:1387-1419`)."""
    prompts = []
    for i in range(min(count, len(dataset))):
        s = dataset[i]
        if s.mel is None:
            continue
        half = max(s.mel.shape[0] // 2, 1)
        text = s.text if isinstance(s.text, str) else "".join(map(str, s.text))
        prompts.append({"ref_mel": s.mel[:half], "ref_text": text, "gen_text": text})
    return prompts
