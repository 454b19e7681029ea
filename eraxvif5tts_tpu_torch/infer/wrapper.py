"""F5TTSWrapper: zero-shot voice cloning on PyTorch (port of
`eraxvif5tts_tpu/infer/wrapper.py`).

Same API and semantics as the JAX wrapper: ``preprocess_reference`` ->
immutable :class:`ReferenceState`; ``generate`` chunks the text by the
reference's byte rate (`max_chars = ref_bytes / ref_sec * (22 - ref_sec)`),
picks a duration bucket per chunk, runs one fused sample-and-vocode step per
chunk (the prompt region is vocoded only from ``ref_frames - 48`` on and
dropped, the wave is RMS-rescaled and returned as int16 PCM), and
cross-fades the chunks. ``generate_batch`` runs several utterances as one
padded batch: one bucket, per-sample durations, one shared noise draw,
per-sample end trim.

``compute_dtype="int8"`` is the JAX package's int8 W8A8 serving
(`ops/quant.py`): a reference checkpoint or the default initialisation is
quantized at load (``params`` must already be a tree quantized by
`quantize_params`, as in JAX); every other backbone matrix is bf16 and every
vector (biases, weight scales) stays fp32, as the JAX wrapper casts them;
the compute dtype is bf16 and the vocoder is as in bf16 serving.
``int8_validate`` runs the quality gate (`ops/quant.quant_divergence`: 8
steps at ``max_duration=256``) against a bf16 twin of the same weights when
the wrapper quantized them, raises past the threshold, keeps the report in
``int8_report`` and frees the twin.

Differences, by design:

- an explicit ``device``; ``compute_dtype="bfloat16"`` (or ``"int8"``, which
  computes in bf16) is the card's serving dtype, and a float32 wrapper on
  CUDA raises at construction (the CUDA kernels take bf16);
- sampler noise comes from a ``torch.Generator`` seeded per request, one
  fresh ``[bucket, n_mels]`` draw per chunk, one per ``generate_batch`` call
  (reproducible from ``seed``, not bit-equal to ``jax.random``);
- weights come from reference checkpoints (``ckpt_path``,
  ``vocoder_ckpt_path``) or the JAX wrapper's parameter trees (``params``,
  ``vocoder_params``); without either, PyTorch's default initialisation;
- ``warmup`` runs the smallest reachable bucket only: there is no per-bucket
  compile to pay ahead of time.

Backbones: the DiT (``F5TTS_v1_*``, ``F5TTS_Base`` / ``F5TTS_Small``) and the
UNetT (``E2TTS_Base`` / ``E2TTS_Small``), built by ``models.build_backbone``.
The UNetT packs its time token as an extra frame 0, so with the default
duration buckets the wrapper takes mel buckets of 64k - 1 frames for it
(`eraxvif5tts_tpu/infer/wrapper.py:168-174`): the transformer then sees
64-aligned sequences, which the serving attention kernel requires.

Not ported yet (ROADMAP.md): MMDiT, BigVGAN, int8 for the UNetT, the duration
predictor, multi-device meshes (``generate_batch`` runs on one device),
automatic transcription of an empty ``ref_text``. Each raises.
"""

from __future__ import annotations

import dataclasses
import random as _random
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from eraxvif5tts_tpu_torch.audio.io import read_wav, write_wav
from eraxvif5tts_tpu_torch.audio.resample import resample
from eraxvif5tts_tpu_torch.audio.silence import clip_reference_audio
from eraxvif5tts_tpu_torch.compression.convert import infer_depth
from eraxvif5tts_tpu_torch.configs import PRESETS, ModelConfig, load_model_config
from eraxvif5tts_tpu_torch.text.chunk import chunk_text
from eraxvif5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from eraxvif5tts_tpu_torch.text.tokenizer import get_tokenizer, list_str_to_idx
from eraxvif5tts_tpu_torch.compression.convert import (
    reference_backbone_state_dict,
    reference_vocos_state_dict,
    state_dict_from_jax,
)
from eraxvif5tts_tpu_torch.infer.utils import (
    DURATION_BUCKETS,
    TEXT_BUCKETS,
    byte_ratio_duration,
    cross_fade_concat,
    pick_bucket,
    rms_of,
)
from eraxvif5tts_tpu_torch.models import build_backbone
from eraxvif5tts_tpu_torch.models.cfm import CFM
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.models.vocos import Vocos
from eraxvif5tts_tpu_torch.ops import quant
from eraxvif5tts_tpu_torch.ops.stft import MelSpectrogram

# Prompt-region frames vocoded in front of the generated region so the cut
# lies outside the decoder's receptive field (+-31 frames), as in the JAX
# wrapper.
VOCODE_MARGIN_FRAMES = 48

# compute dtype of each serving dtype (int8 serving computes in bf16)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.bfloat16}


@dataclass(frozen=True)
class ReferenceState:
    """Preprocessed reference prompt. Immutable; safe to share across requests."""

    mel: torch.Tensor  # [1, n_frames, n_mels] float32 on the wrapper's device
    text: str
    n_frames: int
    audio_len_samples: int
    rms: float

    @property
    def audio_seconds(self) -> float:
        return self.audio_len_samples / 24000.0


class F5TTSWrapper:
    """Zero-shot voice cloning: reference audio + text -> arbitrary speech."""

    def __init__(
        self,
        model_name: str = "F5TTS_v1_Base",
        ckpt_path: Optional[str] = None,
        vocab_file: Optional[str] = None,
        vocab_char_map: Optional[dict[str, int]] = None,
        vocoder_ckpt_path: Optional[str] = None,
        use_ema: bool = True,
        target_rms: float = 0.1,
        target_sample_rate: int = 24000,
        hop_length: int = 256,
        nfe_step: int = 32,
        cfg_strength: float = 2.0,
        sway_sampling_coef: Optional[float] = -1.0,
        speed: float = 1.0,
        compute_dtype: str = "bfloat16",
        int8_validate: bool = False,
        device: str | torch.device = "cuda",
        params: Optional[dict] = None,
        vocoder_params: Optional[dict] = None,
        model_cfg: Optional[ModelConfig] = None,
        duration_buckets: tuple[int, ...] = DURATION_BUCKETS,
        text_buckets: tuple[int, ...] = TEXT_BUCKETS,
    ):
        if model_cfg is not None:
            cfg = model_cfg
        elif model_name in PRESETS:
            cfg = PRESETS[model_name]
        elif model_name.endswith((".yaml", ".yml")):
            cfg = load_model_config(model_name)
        else:
            raise ValueError(f"unknown model {model_name!r} (not a preset or yaml path)")
        if cfg.backbone not in ("DiT", "UNetT") or cfg.mel_spec.mel_spec_type != "vocos":
            raise ValueError(f"only DiT or UNetT + Vocos is ported, got {cfg.backbone} + "
                             f"{cfg.mel_spec.mel_spec_type}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                             f"got {compute_dtype!r}")
        if compute_dtype == "int8" and cfg.backbone != "DiT":
            raise ValueError(f"compute_dtype='int8' serves the DiT only: int8 for the "
                             f"{cfg.backbone} is not ported yet")
        self.device = torch.device(device)
        if self.device.type == "cuda" and compute_dtype == "float32":
            raise ValueError(
                f"compute_dtype={compute_dtype!r} on {self.device}: the CUDA kernels "
                "take bfloat16 only; float32 on the card is not ported yet")
        dtype = _DTYPES[compute_dtype]
        self.compute_dtype = compute_dtype

        if vocab_char_map is not None:
            self.vocab_char_map = vocab_char_map
        elif vocab_file is not None:
            self.vocab_char_map, _ = get_tokenizer(vocab_file, "custom")
        else:
            self.vocab_char_map = None

        self.target_rms = target_rms
        self.target_sample_rate = target_sample_rate
        self.hop_length = hop_length
        self.nfe_step = nfe_step
        self.cfg_strength = cfg_strength
        self.sway_sampling_coef = sway_sampling_coef
        self.speed = speed
        # the UNetT's time token is an extra frame 0: mel buckets of 64k - 1
        # frames give the transformer the 64-aligned sequence the serving
        # attention kernel takes
        if cfg.backbone == "UNetT" and duration_buckets == DURATION_BUCKETS:
            duration_buckets = tuple(b - 1 for b in DURATION_BUCKETS)
        self.duration_buckets = duration_buckets
        self.text_buckets = text_buckets

        state_dict, vocoder_state_dict = state_dict_from_jax(params, vocoder_params, cfg)
        if ckpt_path is not None:
            state_dict = reference_backbone_state_dict(ckpt_path, use_ema=use_ema)
        if vocoder_ckpt_path is not None:
            vocoder_state_dict = reference_vocos_state_dict(vocoder_ckpt_path)
        if state_dict is not None:
            depth = infer_depth(state_dict) or cfg.arch.depth
            if depth != cfg.arch.depth:
                cfg = dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, depth=depth))
            text_num_embeds = state_dict["text_embed.text_embed.weight"].shape[0] - 1
            if self.vocab_char_map and len(self.vocab_char_map) > text_num_embeds:
                raise ValueError(
                    f"vocab has {len(self.vocab_char_map)} tokens but the "
                    f"checkpoint's text embedding holds {text_num_embeds}")
        else:
            text_num_embeds = len(self.vocab_char_map) if self.vocab_char_map else 256
        mel_cfg = cfg.mel_spec
        self.int8_report: Optional[dict] = None
        if compute_dtype == "int8":
            cfg = dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, quantized=True))
            self.transformer = self._build_int8(
                cfg.arch, text_num_embeds, mel_cfg.n_mel_channels, state_dict,
                prequantized=params is not None and ckpt_path is None,
                validate=int8_validate)
        else:
            self.transformer = build_backbone(cfg, text_num_embeds)
            if state_dict is not None:
                self.transformer.load_state_dict(state_dict, strict=True)
            # every backbone weight in the compute dtype, as the JAX wrapper does
            self.transformer.to(device=self.device, dtype=dtype).eval()
        self.config = cfg

        self.vocoder = Vocos(input_channels=mel_cfg.n_mel_channels, n_fft=mel_cfg.n_fft,
                             hop_length=mel_cfg.hop_length, compute_dtype=dtype)
        if vocoder_state_dict is not None:
            self.vocoder.load_state_dict(vocoder_state_dict, strict=True)
        # vocoder parameters stay fp32; its ConvNeXt stack computes in `dtype`
        self.vocoder.to(self.device).eval()

        self.mel_spec = MelSpectrogram(
            n_fft=mel_cfg.n_fft, hop_length=mel_cfg.hop_length,
            win_length=mel_cfg.win_length, n_mel_channels=mel_cfg.n_mel_channels,
            target_sample_rate=mel_cfg.target_sample_rate)
        self.cfm = CFM(self.transformer)
        self.ref: Optional[ReferenceState] = None
        self._last_wave: Optional[np.ndarray] = None

    def _build_int8(self, arch, text_num_embeds: int, mel_dim: int,
                    state_dict: Optional[dict], prequantized: bool, validate: bool) -> DiT:
        """The quantized DiT on the device: ``state_dict`` quantized here (or,
        ``prequantized``, already carrying ``weight_q``), matrices bf16,
        vectors fp32; gated by :func:`quant.quant_divergence` when
        ``validate`` and the fp weights are at hand."""
        fp_arch = dataclasses.replace(arch, quantized=False)
        fp_sd = None
        if prequantized:
            if not any(k.endswith(".weight_q") for k in state_dict):
                raise ValueError("compute_dtype='int8' with params= needs a tree quantized "
                                 "by quantize_params (kernel_q / kernel_scale leaves)")
            q_sd = state_dict
        else:
            fp_sd = state_dict if state_dict is not None else (
                DiT(fp_arch, text_num_embeds, mel_dim).state_dict())
            q_sd = quant.quantize_state_dict(fp_sd, arch.depth)
        dit = DiT(arch, text_num_embeds, mel_dim)
        dit.load_state_dict(q_sd, strict=True)
        quant.cast_for_serving(dit).to(self.device).eval()
        if validate and fp_sd is not None:
            twin = DiT(fp_arch, text_num_embeds, mel_dim)
            twin.load_state_dict(fp_sd, strict=True)
            twin.to(device=self.device, dtype=torch.bfloat16).eval()
            report = quant.quant_divergence(CFM(twin), CFM(dit), steps=8, max_duration=256)
            del twin
            self.int8_report = report
            if not report["passes_gate"]:
                raise ValueError(
                    f"int8 quality gate failed: rel mel-MSE {report['rel_mse']:.4f} > "
                    f"{quant.INT8_REL_MSE_THRESHOLD} (lsd {report['lsd_db']:.2f} dB) — serve "
                    "with compute_dtype='bfloat16' instead")
        return dit

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _sample_vocode(self, cond, text, duration, lens, noise, rms_scale, *, steps,
                       cfg_strength, sway, max_duration, vocode_start=0, gen_start=0):
        """The fused step of one chunk: sample the mel, vocode it from
        ``vocode_start`` on, rescale and clip to int16 PCM, drop the first
        ``gen_start`` frames. Returns ``(pcm [b, samples] int16, mel)``."""
        mel = self.cfm.sample(cond, text, duration, lens, noise=noise, steps=steps,
                              cfg_strength=cfg_strength, sway_sampling_coef=sway,
                              max_duration=max_duration)
        wave = self.vocoder(mel[:, vocode_start:].transpose(1, 2)) * rms_scale
        pcm = torch.clamp(wave, -1.0, 1.0) * 32767.0
        return pcm[:, gen_start * self.hop_length:].to(torch.int16), mel

    def _draw_noise(self, generator: torch.Generator, n_frames: int) -> torch.Tensor:
        """One chunk's ``[n_frames, n_mels]`` sampler noise."""
        return torch.randn((n_frames, self.transformer.mel_dim), generator=generator,
                           device=self.device)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def preprocess_reference(self, ref_audio_path: Optional[str] = None,
                             ref_text: str = "", clip_short: bool = True,
                             ref_audio: Optional[np.ndarray] = None,
                             ref_sample_rate: Optional[int] = None) -> ReferenceState:
        """Load + clip + RMS-normalise the reference prompt and compute its mel
        on the device (parity: the JAX wrapper's ``preprocess_reference``)."""
        if ref_audio is None:
            if ref_audio_path is None:
                raise ValueError("need ref_audio_path or ref_audio")
            wav, sr = read_wav(ref_audio_path)
            wav = wav.mean(axis=0)
        else:
            wav = np.asarray(ref_audio, dtype=np.float32).reshape(-1)
            sr = ref_sample_rate or self.target_sample_rate
        wav = clip_reference_audio(wav, sr, clip_short=clip_short)
        rms = rms_of(wav)
        if 0 < rms < self.target_rms:
            wav = wav * (self.target_rms / rms)
        if sr != self.target_sample_rate:
            wav = resample(wav, sr, self.target_sample_rate)
        if not ref_text.strip():
            raise ValueError("ref_text is required: automatic transcription is not "
                             "ported yet")
        if not ref_text.endswith(". ") and not ref_text.endswith("。"):
            ref_text = ref_text + " " if ref_text.endswith(".") else ref_text + ". "

        n_frames = len(wav) // self.hop_length
        wav = np.asarray(wav[: n_frames * self.hop_length], dtype=np.float32)
        mel = self.mel_spec(torch.from_numpy(wav[None]).to(self.device))
        mel = mel.transpose(1, 2)[:, :n_frames].contiguous()  # [1, n_frames, n_mels]
        state = ReferenceState(mel=mel, text=ref_text, n_frames=n_frames,
                               audio_len_samples=len(wav), rms=rms)
        self.ref = state
        return state

    # ------------------------------------------------------------------

    def warmup(self, ref: Optional[ReferenceState] = None,
               nfe_step: Optional[int] = None) -> int:
        """Run the fused step once at the smallest bucket a request can reach,
        so that the first request does not pay for the kernel build, the text
        frontend's first call or the allocator's growth. Returns that bucket."""
        ref = ref or self.ref
        if ref is None:
            raise RuntimeError("call preprocess_reference() first or pass ref=")
        convert_char_to_pinyin([ref.text + " warmup."])
        nfe = nfe_step if nfe_step is not None else self.nfe_step
        bucket = pick_bucket(ref.n_frames + 1, self.duration_buckets)
        vstart = max(ref.n_frames - VOCODE_MARGIN_FRAMES, 0)
        generator = torch.Generator(device=self.device).manual_seed(0)
        text_ids = torch.full((1, self.text_buckets[0]), -1, dtype=torch.long,
                              device=self.device)
        text_ids[0, 0] = 0
        pcm, _ = self._sample_vocode(
            ref.mel, text_ids, torch.tensor([bucket], device=self.device),
            torch.tensor([ref.n_frames], device=self.device),
            self._draw_noise(generator, bucket), 1.0, steps=nfe,
            cfg_strength=float(self.cfg_strength), sway=self.sway_sampling_coef,
            max_duration=bucket, vocode_start=vstart, gen_start=ref.n_frames - vstart)
        pcm.cpu()
        return bucket

    def _max_chars_for(self, ref: ReferenceState) -> tuple[int, int]:
        """Chunking rule: (max_chars, hard cap), as in the JAX wrapper."""
        ref_sec = max(ref.audio_seconds, 1e-3)
        ref_bytes = len(ref.text.encode("utf-8"))
        max_chars = int(ref_bytes / ref_sec * max(22.0 - ref_sec, 1.0))
        bucket_budget = max(self.text_buckets[-1] - ref_bytes - 2, 16)
        return min(max(max_chars, 16), bucket_budget), bucket_budget

    def generate(self, text: str, output_path: Optional[str] = None,
                 ref: Optional[ReferenceState] = None, nfe_step: Optional[int] = None,
                 cfg_strength: Optional[float] = None, speed: Optional[float] = None,
                 sway_sampling_coef: Optional[float] = None,
                 fix_duration: Optional[float] = None, cross_fade_duration: float = 0.15,
                 seed: Optional[int] = None, return_numpy: bool = False,
                 return_spectrogram: bool = False, use_pinyin: bool = True):
        """Synthesise ``text`` in the reference voice. Returns the output path
        (when ``output_path`` is given), else the float32 waveform (and the
        generated mel frames with ``return_spectrogram``)."""
        ref = ref or self.ref
        if ref is None:
            raise RuntimeError("call preprocess_reference() first or pass ref=")
        if self.vocab_char_map is None:
            raise RuntimeError("wrapper needs a vocab (vocab_file/vocab_char_map)")
        nfe_step = nfe_step if nfe_step is not None else self.nfe_step
        cfg_strength = cfg_strength if cfg_strength is not None else self.cfg_strength
        speed = speed if speed is not None else self.speed
        sway = sway_sampling_coef if sway_sampling_coef is not None else self.sway_sampling_coef

        max_chars, bucket_budget = self._max_chars_for(ref)
        chunks = chunk_text(text, max_chars=max_chars, hard_max=bucket_budget)
        generator = torch.Generator(device=self.device).manual_seed(
            seed if seed is not None else _random.randrange(2**31))
        vstart = max(ref.n_frames - VOCODE_MARGIN_FRAMES, 0)
        rms_scale = ref.rms / self.target_rms if 0 < ref.rms < self.target_rms else 1.0

        waves: list[np.ndarray] = []
        mels: list[np.ndarray] = []
        for chunk in chunks:
            local_speed = 0.3 if len(chunk.encode("utf-8")) < 10 else speed
            full_text = ref.text + chunk
            tokens = convert_char_to_pinyin([full_text]) if use_pinyin else [list(full_text)]
            duration = max(byte_ratio_duration(ref.n_frames, ref.text, chunk, local_speed,
                                               hop_length=self.hop_length,
                                               sample_rate=self.target_sample_rate,
                                               fix_duration=fix_duration),
                           ref.n_frames + 1)
            bucket = pick_bucket(duration, self.duration_buckets)
            duration = min(duration, bucket)
            text_ids = list_str_to_idx(tokens, self.vocab_char_map,
                                       pad_to=pick_bucket(len(tokens[0]), self.text_buckets))
            pcm, mel = self._sample_vocode(
                ref.mel, torch.from_numpy(text_ids).to(self.device, torch.long),
                torch.tensor([duration], device=self.device),
                torch.tensor([ref.n_frames], device=self.device),
                self._draw_noise(generator, bucket), rms_scale, steps=nfe_step,
                cfg_strength=float(cfg_strength),
                sway=float(sway) if sway is not None else None,
                max_duration=bucket, vocode_start=vstart, gen_start=ref.n_frames - vstart)
            n_samples = (duration - ref.n_frames) * self.hop_length
            waves.append(pcm[0, :n_samples].cpu().numpy().astype(np.float32) / 32767.0)
            if return_spectrogram:
                mels.append(mel[0, ref.n_frames:duration].T.cpu().numpy())

        final = cross_fade_concat(waves, self.target_sample_rate, cross_fade_duration)
        self._last_wave = final
        if output_path is not None:
            write_wav(output_path, final, self.target_sample_rate)
            if return_spectrogram and mels:
                return output_path, np.concatenate(mels, axis=1)
            return output_path
        if return_spectrogram and mels:
            return final, np.concatenate(mels, axis=1)
        return final

    def generate_batch(self, texts: list[str], ref: Optional[ReferenceState] = None,
                       nfe_step: Optional[int] = None, cfg_strength: Optional[float] = None,
                       speed: Optional[float] = None,
                       sway_sampling_coef: Optional[float] = None, seed: Optional[int] = None,
                       use_pinyin: bool = True) -> list[np.ndarray]:
        """Synthesise several utterances in one padded batch (the JAX
        ``generate_batch`` without its mesh branch): one duration bucket and
        one text bucket for all, per-sample durations, the prompt length as
        every sample's ``lens``, one ``[bucket, n_mels]`` noise draw shared by
        every sample, and each wave trimmed to its own duration. Returns one
        float32 waveform per text (no chunking, no cross-fade)."""
        ref = ref or self.ref
        if ref is None:
            raise RuntimeError("call preprocess_reference() first or pass ref=")
        if not texts:
            return []
        if self.vocab_char_map is None:
            raise RuntimeError("wrapper needs a vocab (vocab_file/vocab_char_map)")
        nfe_step = nfe_step if nfe_step is not None else self.nfe_step
        cfg_strength = cfg_strength if cfg_strength is not None else self.cfg_strength
        speed = speed if speed is not None else self.speed
        sway = sway_sampling_coef if sway_sampling_coef is not None else self.sway_sampling_coef

        token_lists, durations = [], []
        for text in texts:
            local_speed = 0.3 if len(text.encode("utf-8")) < 10 else speed
            full = ref.text + text
            token_lists.append(convert_char_to_pinyin([full])[0] if use_pinyin else list(full))
            durations.append(max(byte_ratio_duration(ref.n_frames, ref.text, text, local_speed,
                                                     hop_length=self.hop_length,
                                                     sample_rate=self.target_sample_rate),
                                 ref.n_frames + 1))
        bucket = pick_bucket(max(durations), self.duration_buckets)
        durations = [min(d, bucket) for d in durations]
        text_ids = list_str_to_idx(token_lists, self.vocab_char_map,
                                   pad_to=pick_bucket(max(map(len, token_lists)),
                                                      self.text_buckets))
        b = len(texts)
        generator = torch.Generator(device=self.device).manual_seed(
            seed if seed is not None else _random.randrange(2**31))
        vstart = max(ref.n_frames - VOCODE_MARGIN_FRAMES, 0)
        rms_scale = ref.rms / self.target_rms if 0 < ref.rms < self.target_rms else 1.0
        pcm, _ = self._sample_vocode(
            ref.mel.expand(b, -1, -1), torch.from_numpy(text_ids).to(self.device, torch.long),
            torch.tensor(durations, device=self.device),
            torch.full((b,), ref.n_frames, device=self.device),
            self._draw_noise(generator, bucket), rms_scale, steps=nfe_step,
            cfg_strength=float(cfg_strength), sway=float(sway) if sway is not None else None,
            max_duration=bucket, vocode_start=vstart, gen_start=ref.n_frames - vstart)
        pcm = pcm.cpu().numpy()
        return [pcm[i, :(d - ref.n_frames) * self.hop_length].astype(np.float32) / 32767.0
                for i, d in enumerate(durations)]

    def get_current_audio_length(self) -> float:
        """Seconds of the most recently generated audio."""
        if self._last_wave is None:
            return 0.0
        return len(self._last_wave) / self.target_sample_rate
