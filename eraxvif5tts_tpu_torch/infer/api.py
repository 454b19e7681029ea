"""Porcelain API on the port's wrapper (port of `eraxvif5tts_tpu/infer/api.py`;
reference `src/f5_tts/api.py:23-149`): ``F5TTS`` with ``infer``,
``export_wav``, ``export_spectrogram``; seeded via ``seed_everything``
semantics (a random seed when None, `api.py:117-119`).

``device=None`` is the card (``cuda``); ``"cuda"``, ``"cuda:N"`` and ``"cpu"``
are accepted, anything else raises. The wrapper computes in fp32 on every
device, as the JAX API's does (`utils_infer.compute_dtype_for`).
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from eraxvif5tts_tpu_torch.audio.io import write_wav
from eraxvif5tts_tpu_torch.infer.utils_infer import (
    compute_dtype_for,
    infer_process,
    preprocess_ref_audio_text,
    remove_silence_for_generated_wav,
    resolve_device,
    save_spectrogram,
)
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper


class F5TTS:
    def __init__(
        self,
        model: str = "F5TTS_v1_Base",
        ckpt_file: str = "",
        vocab_file: str = "",
        vocoder_local_path: Optional[str] = None,
        ode_method: str = "euler",
        use_ema: bool = True,
        device: Optional[str] = None,
        hf_cache_dir: Optional[str] = None,
    ):
        if ode_method != "euler":
            raise ValueError(
                f"ode_method {ode_method!r} not implemented (the sampler is the "
                "reference's default fixed-step Euler, `cfm.py:197`)")
        dev = resolve_device(device)
        if hf_cache_dir is not None:
            raise ValueError(
                "hf_cache_dir is a HF-download knob; this runtime is offline — "
                "pass ckpt_file/vocab_file paths directly")
        self.wrapper = F5TTSWrapper(
            model_name=model,
            ckpt_path=ckpt_file or None,
            vocab_file=vocab_file or None,
            vocoder_ckpt_path=vocoder_local_path,
            use_ema=use_ema,
            device=dev,
            compute_dtype=compute_dtype_for(dev),
        )
        self.device = dev
        self.target_sample_rate = self.wrapper.target_sample_rate
        self.seed: Optional[int] = None

    def export_wav(self, wav: np.ndarray, file_wave: str, remove_silence: bool = False):
        write_wav(file_wave, wav, self.target_sample_rate)
        if remove_silence:
            remove_silence_for_generated_wav(file_wave)

    def export_spectrogram(self, spec: np.ndarray, file_spec: str):
        save_spectrogram(spec, file_spec)

    def transcribe(self, ref_audio: str, language: Optional[str] = None) -> str:
        from eraxvif5tts_tpu_torch.infer.utils_infer import transcribe

        return transcribe(ref_audio, language)

    def infer(
        self,
        ref_file: str,
        ref_text: str,
        gen_text: str,
        show_info=print,
        progress=None,
        target_rms: float = 0.1,
        cross_fade_duration: float = 0.15,
        sway_sampling_coef: float = -1.0,
        cfg_strength: float = 2.0,
        nfe_step: int = 32,
        speed: float = 1.0,
        fix_duration=None,
        remove_silence: bool = False,
        file_wave: Optional[str] = None,
        file_spec: Optional[str] = None,
        seed: Optional[int] = None,
    ):
        if seed is None:
            seed = random.randint(0, 2**31 - 1)
        self.seed = seed

        ref_file, ref_text = preprocess_ref_audio_text(ref_file, ref_text,
                                                       show_info=show_info)
        wav, sr, spec = infer_process(
            ref_file, ref_text, gen_text, self.wrapper,
            show_info=show_info, progress=progress, target_rms=target_rms,
            cross_fade_duration=cross_fade_duration, nfe_step=nfe_step,
            cfg_strength=cfg_strength, sway_sampling_coef=sway_sampling_coef,
            speed=speed, fix_duration=fix_duration, seed=seed,
        )
        if file_wave is not None:
            self.export_wav(wav, file_wave, remove_silence)
        if file_spec is not None:
            self.export_spectrogram(spec, file_spec)
        return wav, sr, spec
