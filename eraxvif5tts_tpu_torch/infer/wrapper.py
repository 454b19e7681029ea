"""F5TTSWrapper: zero-shot voice cloning on PyTorch (port of
`eraxvif5tts_tpu/infer/wrapper.py`).

Same API and semantics as the JAX wrapper: ``preprocess_reference`` ->
immutable :class:`ReferenceState`; ``generate`` chunks the text by the
reference's byte rate (`max_chars = ref_bytes / ref_sec * (22 - ref_sec)`),
picks a duration bucket per chunk, runs one fused sample-and-vocode step per
chunk (the prompt region is vocoded only from ``ref_frames - 48`` on and
dropped, the wave is RMS-rescaled and returned as int16 PCM), keeps up to
three chunks in flight before it fetches their PCM, and cross-fades the
chunks. ``generate_batch`` runs several utterances as one
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
``int8_report`` and frees the twin. The gate's text is 32 tokens padded to
64 ids, so the MMDiT's joint sequence, 64 + 256, is 64-aligned.

Differences, by design:

- an explicit ``device`` (the card unless the caller asks for the CPU). The
  compute dtype defaults to ``"float32"``, as the JAX wrapper's does
  (`eraxvif5tts_tpu/infer/wrapper.py:126`), on the card too: its attention
  runs the fp32 kernel and its feed-forward the unfused branch, with TF32
  off for every backbone and vocoder call (``models.modules.full_fp32``).
  ``compute_dtype="bfloat16"`` serves in bf16 (the fused kernels), and
  ``"int8"`` computes in bf16;
- sampler noise comes from a ``torch.Generator`` seeded per request, one
  fresh ``[bucket, n_mels]`` draw per chunk, one per ``generate_batch`` call
  (reproducible from ``seed``, not bit-equal to ``jax.random``);
- weights come from reference checkpoints (``ckpt_path``,
  ``vocoder_ckpt_path``), from a ``model_*`` directory of the port's own
  trainer (``ckpt_path``: the EMA weights, or the raw parameters with
  ``use_ema=False``) or from the JAX wrapper's parameter trees (``params``,
  ``vocoder_params``); without any, PyTorch's default initialisation;
- the JAX wrapper compiles the fused step once per jit key; on the card the
  port captures it once per key as a CUDA graph, and a chunk is one replay
  (:meth:`F5TTSWrapper._dispatch_sample_vocode`). On the CPU the step runs
  eagerly. ``warmup`` has the JAX wrapper's signature, loop and result, and
  captures every pair it warms.

CUDA graphs. The key is the JAX jit's cache key: the six static arguments
(``steps``, ``cfg_strength``, ``sway``, ``max_duration``, ``vocode_start``,
``gen_start``), the shapes and dtypes of the six tensor arguments, and the
gates read at call time (``ERAX_INT8_FF``, torch's two TF32 flags). A key's
first call runs the step eagerly with one Euler step (the kernels are built,
the library plans made, every host cache the step reads is filled), captures
it on a side stream, then replays it; a capture that fails, or a host cache that grows
while it is captured, raises (there is no eager fallback on the card). Every
call copies its tensors into the key's input buffers, replays, and returns
copies of the outputs. A wrapper's graphs share one memory pool, so they take
the memory of the largest key (plus their outputs), and one lock serialises
their replays. A replay reads the weights by address: update them in place
(``load_state_dict`` does), never by replacing a parameter tensor.

Backbones: the DiT (``F5TTS_v1_*``, ``F5TTS_Base`` / ``F5TTS_Small``), the
UNetT (``E2TTS_Base`` / ``E2TTS_Small``) and the MMDiT (``F5TTS_v1_MMDiT``),
built by ``models.build_backbone``. The UNetT packs its time token as an
extra frame 0, so with the default duration buckets the wrapper takes mel
buckets of 64k - 1 frames for it (`eraxvif5tts_tpu/infer/wrapper.py:168-174`):
the transformer then sees 64-aligned sequences, which the serving attention
kernel requires. The MMDiT's joint sequence is the text bucket plus the mel
bucket, 64-aligned as both are. All three serve in int8 W8A8
(``compute_dtype="int8"``, quantized at load behind the quality gate with
``int8_validate``).

Vocoders: Vocos, or BigVGAN with ``vocoder_name="bigvgan"``
(``vocoder_config`` a ``models.bigvgan.BigVGANConfig``, default
`bigvgan_v2_24khz_100band_256x`). As in the JAX wrapper, a ``vocoder_name``
that differs from the configuration's mel frontend overrides it, so the
conditioning mels are the ones the vocoder was trained on; BigVGAN's weights
come from ``vocoder_params`` (the JAX tree), from ``vocoder_ckpt_path`` (a
reference generator checkpoint) or else from the JAX wrapper's random draw
(`BigVGAN.init_random_params(np.random.default_rng(1))`). BigVGAN vocodes
in fp32 (TF32 off) whatever the backbone's dtype, and its receptive
field of about 25 mel frames fits inside the vocode margin.

The phoneme duration predictor (``duration_predictor_ckpt``, a reference-format
checkpoint with its ``phoneme_map``; `models/duration.py`) is loaded on the
wrapper's device whenever a checkpoint is given and sets each chunk's (and
each ``generate_batch`` sample's) duration when ``use_duration_predictor``
is on, as in the JAX wrapper: ``fix_duration`` wins, a prediction of 0
frames falls back to ``byte_ratio_duration``.

Several devices (``mesh``, a ``parallel.mesh.make_mesh`` mesh; every
process of it builds the wrapper and makes the same calls): the backbone is
put on the mesh (the DiT split over ``model`` by the JAX rules, every other
backbone replicated, `parallel/mesh.py`), rank 0's weights for all;
``generate_batch`` pads the batch to a multiple of ``data`` as the JAX
wrapper does, each data rank samples its rows with the one shared noise
draw, and every rank returns the whole list, gathered after the step. With
``model = 1`` a chunk step holds no collective and stays one CUDA graph
replay; with ``model > 1`` it holds the row projections' all-reduces,
which an NCCL group's graph captures with the rest of the step; over gloo,
which cannot capture them, the step runs eagerly, with a printed line (the
kernels still launch on the card). A request's seed is rank 0's.

Not ported yet (ROADMAP.md): the default Whisper backend behind an empty
``ref_text`` (pass ``transcribe_fn``), which raises.
"""

from __future__ import annotations

import dataclasses
import random as _random
import threading
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
    bigvgan_state_dict_from_reference,
    is_trainer_checkpoint,
    reference_backbone_state_dict,
    reference_vocos_state_dict,
    state_dict_from_jax,
    trainer_backbone_state_dict,
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
from eraxvif5tts_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, random_state_dict
from eraxvif5tts_tpu_torch.models.cfm import CFM
from eraxvif5tts_tpu_torch.models.vocos import Vocos
from eraxvif5tts_tpu_torch.ops import _cuda, quant, quant_ff, serving_attention
from eraxvif5tts_tpu_torch.parallel import mesh as pm
from eraxvif5tts_tpu_torch.ops.stft import MelSpectrogram

# Prompt-region frames vocoded in front of the generated region so the cut
# lies outside the decoder's receptive field (Vocos +-31 frames, BigVGAN
# about 25), as in the JAX wrapper.
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


@dataclass
class _ChunkGraph:
    """One key's captured step: the graph, its input buffers (ordinary
    allocations), its outputs (in the wrapper's graph pool) and what the
    capture recorded (the launches a replay stands for, the cached tensors
    the graph reads)."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: tuple
    record: _cuda.Capture


class F5TTSWrapper:
    """Zero-shot voice cloning: reference audio + text -> arbitrary speech."""

    def __init__(
        self,
        model_name: str = "F5TTS_v1_Base",
        ckpt_path: Optional[str] = None,
        vocab_file: Optional[str] = None,
        vocab_char_map: Optional[dict[str, int]] = None,
        vocoder_ckpt_path: Optional[str] = None,
        vocoder_name: Optional[str] = None,
        vocoder_config: Optional[BigVGANConfig] = None,
        use_ema: bool = True,
        target_rms: float = 0.1,
        target_sample_rate: int = 24000,
        hop_length: int = 256,
        nfe_step: int = 32,
        cfg_strength: float = 2.0,
        sway_sampling_coef: Optional[float] = -1.0,
        speed: float = 1.0,
        use_duration_predictor: bool = False,
        duration_predictor_ckpt: Optional[str] = None,
        compute_dtype: str = "float32",
        int8_validate: bool = False,
        device: str | torch.device = "cuda",
        params: Optional[dict] = None,
        vocoder_params: Optional[dict] = None,
        model_cfg: Optional[ModelConfig] = None,
        duration_buckets: tuple[int, ...] = DURATION_BUCKETS,
        text_buckets: tuple[int, ...] = TEXT_BUCKETS,
        mesh=None,
    ):
        if model_cfg is not None:
            cfg = model_cfg
        elif model_name in PRESETS:
            cfg = PRESETS[model_name]
        elif model_name.endswith((".yaml", ".yml")):
            cfg = load_model_config(model_name)
        else:
            raise ValueError(f"unknown model {model_name!r} (not a preset or yaml path)")
        # vocoder_name selects vocos | bigvgan and overrides the model's mel
        # frontend (`eraxvif5tts_tpu/infer/wrapper.py:145-156`)
        if vocoder_name is None:
            vocoder_name = cfg.mel_spec.mel_spec_type
        if vocoder_name not in ("vocos", "bigvgan"):
            raise ValueError(f"vocoder_name must be 'vocos' or 'bigvgan', got {vocoder_name!r}")
        if vocoder_name != cfg.mel_spec.mel_spec_type:
            cfg = dataclasses.replace(
                cfg, mel_spec=dataclasses.replace(cfg.mel_spec, mel_spec_type=vocoder_name))
        self.mel_spec_type = vocoder_name
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                             f"got {compute_dtype!r}")
        if compute_dtype == "int8":
            quant.quantized_weight_keys(cfg.arch.depth, cfg.backbone)  # an unknown backbone raises
        self.device = torch.device(device)
        if mesh is not None and self.device.type == "cuda" and self.device.index is None:
            self.device = pm.local_device()
        self.mesh = mesh
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
        self.use_duration_predictor = use_duration_predictor
        # the UNetT's time token is an extra frame 0: mel buckets of 64k - 1
        # frames give the transformer the 64-aligned sequence the serving
        # attention kernel takes
        if cfg.backbone == "UNetT" and duration_buckets == DURATION_BUCKETS:
            duration_buckets = tuple(b - 1 for b in DURATION_BUCKETS)
        self.duration_buckets = duration_buckets
        self.text_buckets = text_buckets

        bigvgan_config = None
        if vocoder_name == "bigvgan":
            bigvgan_config = vocoder_config or BigVGANConfig()
        state_dict, vocoder_state_dict = state_dict_from_jax(params, vocoder_params, cfg,
                                                             bigvgan_config)
        if ckpt_path is not None:
            # the port trainer's own `model_*` directory (EMA weights, or the
            # raw parameters) or a reference checkpoint file
            load = (trainer_backbone_state_dict if is_trainer_checkpoint(ckpt_path)
                    else reference_backbone_state_dict)
            state_dict = load(ckpt_path, use_ema=use_ema)
        if vocoder_ckpt_path is not None and bigvgan_config is not None:
            vocoder_state_dict = bigvgan_state_dict_from_reference(
                torch.load(vocoder_ckpt_path, map_location="cpu", weights_only=True),
                bigvgan_config)
        elif vocoder_ckpt_path is not None:
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
                cfg, text_num_embeds, state_dict,
                prequantized=params is not None and ckpt_path is None,
                validate=int8_validate)
        else:
            self.transformer = build_backbone(cfg, text_num_embeds)
            if state_dict is not None:
                self.transformer.load_state_dict(state_dict, strict=True)
            # every backbone weight in the compute dtype, as the JAX wrapper does
            self.transformer.to(device=self.device, dtype=dtype).eval()
        self.config = cfg

        if bigvgan_config is not None:
            # fp32 whatever the backbone's dtype, as in the JAX wrapper
            self.vocoder = BigVGAN(bigvgan_config)
            if vocoder_state_dict is None:
                vocoder_state_dict = {k: torch.from_numpy(v) for k, v in random_state_dict(
                    bigvgan_config, np.random.default_rng(1)).items()}
        else:
            # parameters stay fp32; its ConvNeXt stack computes in `dtype`
            self.vocoder = Vocos(input_channels=mel_cfg.n_mel_channels, n_fft=mel_cfg.n_fft,
                                 hop_length=mel_cfg.hop_length, compute_dtype=dtype)
        if vocoder_state_dict is not None:
            self.vocoder.load_state_dict(vocoder_state_dict, strict=True)
        self.vocoder.to(self.device).eval()
        # the chunk step's collectives (row projections over `model`): an
        # NCCL group's are captured in the key's CUDA graph with the rest of
        # the step; a gloo group's cannot be, and that step runs eagerly
        model_group = pm.axis_group(mesh, "model")
        self._eager_step = (model_group is not None
                            and torch.distributed.get_backend(model_group) != "nccl")
        if mesh is not None:
            if pm.process_count(mesh) > 1:
                pm.broadcast_flat([t for m in (self.transformer, self.vocoder)
                                   for t in m.state_dict().values()], 0,
                                  torch.distributed.group.WORLD)
            pm.shard_model(self.transformer, mesh)
            if self._eager_step and pm.is_main(mesh):
                print(f"[wrapper] model={pm.axis_size(mesh, 'model')} over "
                      f"{torch.distributed.get_backend(model_group)}: the chunk step holds "
                      "all-reduces that the group cannot capture and runs eagerly (no CUDA graph)")

        self.mel_spec = MelSpectrogram(
            n_fft=mel_cfg.n_fft, hop_length=mel_cfg.hop_length,
            win_length=mel_cfg.win_length, n_mel_channels=mel_cfg.n_mel_channels,
            target_sample_rate=mel_cfg.target_sample_rate, mel_spec_type=vocoder_name)
        self.cfm = CFM(self.transformer)
        self.duration_predictor = None
        self.phoneme_map: dict[str, int] = {}
        if duration_predictor_ckpt is not None:
            from eraxvif5tts_tpu_torch.models.duration import load_duration_predictor

            self.duration_predictor, self.phoneme_map = load_duration_predictor(
                duration_predictor_ckpt, device=self.device)
        self.ref: Optional[ReferenceState] = None
        self._last_wave: Optional[np.ndarray] = None
        # the fused step's dispatch: every key seen, and on the card its graphs
        self.dispatch_keys: set = set()
        self.graph_replays = 0
        self._graphs: dict = {}
        self._graph_lock = threading.Lock()
        self._graph_pool = None
        self._capture_stream = None

    def _build_int8(self, cfg: ModelConfig, text_num_embeds: int, state_dict: Optional[dict],
                    prequantized: bool, validate: bool) -> torch.nn.Module:
        """The quantized backbone (DiT, UNetT or MMDiT) on the device: ``state_dict``
        quantized here (or, ``prequantized``, already carrying ``weight_q``),
        matrices bf16, vectors fp32; gated by :func:`quant.quant_divergence`
        when ``validate`` and the fp weights are at hand (the UNetT's at 255
        frames, a 64-aligned sequence with its time token)."""
        fp_cfg = dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, quantized=False))
        fp_sd = None
        if prequantized:
            if not any(k.endswith(".weight_q") for k in state_dict):
                raise ValueError("compute_dtype='int8' with params= needs a tree quantized "
                                 "by quantize_params (kernel_q / kernel_scale leaves)")
            q_sd = state_dict
        else:
            fp_sd = state_dict if state_dict is not None else (
                build_backbone(fp_cfg, text_num_embeds).state_dict())
            q_sd = quant.quantize_state_dict(fp_sd, cfg.arch.depth, cfg.backbone)
        net = build_backbone(cfg, text_num_embeds)
        net.load_state_dict(q_sd, strict=True)
        quant.cast_for_serving(net).to(self.device).eval()
        if validate and fp_sd is not None:
            twin = build_backbone(fp_cfg, text_num_embeds)
            twin.load_state_dict(fp_sd, strict=True)
            twin.to(device=self.device, dtype=torch.bfloat16).eval()
            max_duration = 255 if cfg.backbone == "UNetT" else 256
            report = quant.quant_divergence(CFM(twin), CFM(net), steps=8,
                                            max_duration=max_duration)
            del twin
            self.int8_report = report
            if not report["passes_gate"]:
                raise ValueError(
                    f"int8 quality gate failed: rel mel-MSE {report['rel_mse']:.4f} > "
                    f"{quant.INT8_REL_MSE_THRESHOLD} (lsd {report['lsd_db']:.2f} dB) — serve "
                    "with compute_dtype='bfloat16' instead")
        return net

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _sample_vocode(self, cond, text, duration, lens, noise, rms_scale, *, steps,
                       cfg_strength, sway, max_duration, vocode_start=0, gen_start=0):
        """The fused step of one chunk: sample the mel, vocode it from
        ``vocode_start`` on, rescale by ``rms_scale`` (a 0-d fp32 tensor, as
        the JAX step's traced argument) and clip to int16 PCM, drop the first
        ``gen_start`` frames. Returns ``(pcm [b, samples] int16, mel)``."""
        mel = self.cfm.sample(cond, text, duration, lens, noise=noise, steps=steps,
                              cfg_strength=cfg_strength, sway_sampling_coef=sway,
                              max_duration=max_duration)
        wave = self.vocoder(mel[:, vocode_start:].transpose(1, 2)) * rms_scale
        pcm = torch.clamp(wave, -1.0, 1.0) * 32767.0
        return pcm[:, gen_start * self.hop_length:].to(torch.int16), mel

    def _dispatch_sample_vocode(self, cond, text, duration, lens, noise, rms_scale, *, steps,
                                cfg_strength, sway, max_duration, vocode_start=0,
                                gen_start=0):
        """:meth:`_sample_vocode` as one dispatch (the JAX wrapper's
        ``_sample_vocode_jit``): eagerly for CPU tensors; on the card one
        replay of the key's CUDA graph, captured at the key's first call.
        Returns copies that the caller owns, never the graph's buffers."""
        tensors = (cond, text, duration, lens, noise, rms_scale)
        static = dict(steps=steps, cfg_strength=cfg_strength, sway=sway,
                      max_duration=max_duration, vocode_start=vocode_start, gen_start=gen_start)
        key = (*static.values(), *((tuple(t.shape), t.dtype) for t in tensors),
               quant_ff.use_int8_ff(), torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        self.dispatch_keys.add(key)
        if cond.device.type != "cuda" or self._eager_step:
            return self._sample_vocode(*tensors, **static)
        # graphs that share a pool must not run at once: one replay at a time,
        # from the inputs' copy to the outputs' (all on the caller's stream)
        with self._graph_lock, torch.inference_mode():
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture(tensors, static)
            for buf, t in zip(entry.inputs, tensors):
                buf.copy_(t)
            entry.graph.replay()
            _cuda.add_launches(entry.record.launches)
            self.graph_replays += 1
            return tuple(t.clone() for t in entry.outputs)

    def _host_caches(self) -> dict:
        """The keys of every host cache the step reads that holds device
        tensors: a graph captured while one grows would leave it holding
        tensors written only by replays."""
        with serving_attention._LOCK:
            caches = {"serving_attention tables": set(serving_attention._TABLES),
                      "serving_attention lengths": set(serving_attention._FULL_LENS)}
        caches["rotary angles"] = set(getattr(self.transformer, "_rope", {}))
        return caches

    def _capture(self, tensors: tuple, static: dict) -> _ChunkGraph:
        """A key's first call: its input buffers, one eager run of the step
        on them, then its capture into the wrapper's graph pool, both on a
        side stream. Raises if the capture fails or a host cache grows.

        The eager run takes one Euler step: every step calls the backbone at
        the same shapes, so one builds the kernels, makes the library plans
        and fills the host caches as all of them would (the check after the
        capture holds it to that)."""
        inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in tensors)
        for buf, t in zip(inputs, tensors):
            buf.copy_(t)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            self._sample_vocode(*inputs, **{**static, "steps": 1})
            before = self._host_caches()
            # thread_local: the server's other threads keep using the card
            # (their copies and noise draws) while this one captures
            with _cuda.capture() as record:
                graph.capture_begin(pool=self._graph_pool, capture_error_mode="thread_local")
                try:
                    outputs = self._sample_vocode(*inputs, **static)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is void; the step's own error is the one to see
                    raise
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        grown = {name: sorted(map(str, keys - before[name]))
                 for name, keys in self._host_caches().items() if keys - before[name]}
        if grown:
            raise RuntimeError(f"host caches grew while the step was captured: {grown}")
        return _ChunkGraph(graph, inputs, outputs, record)

    def _device_tensor(self, values, dtype: torch.dtype = torch.long) -> torch.Tensor:
        """``values`` on the wrapper's device; on the card through pinned
        memory without waiting for the stream, so that the host can queue a
        chunk while the card still runs the one before."""
        t = torch.as_tensor(values, dtype=dtype)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _fetch_async(self, *tensors):
        """Queue copies of ``tensors`` (None stays None) to the host: returns
        them and an event to wait on before reading them (None on the CPU,
        where they are the tensors themselves)."""
        if self.device.type != "cuda":
            return (*tensors, None)
        host = tuple(None if t is None else
                     torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                         t, non_blocking=True) for t in tensors)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return (*host, done)

    def _rms_scale(self, ref: ReferenceState) -> torch.Tensor:
        """The 0-d fp32 factor that restores a quiet reference's loudness."""
        scale = ref.rms / self.target_rms if 0 < ref.rms < self.target_rms else 1.0
        return self._device_tensor(scale, torch.float32)

    def _seed(self, seed: Optional[int]) -> int:
        """A request's seed: ``seed``, or a random one (rank 0's on a mesh)."""
        if seed is None:
            seed = _random.randrange(2**31)
        if pm.process_count(self.mesh) > 1:
            import torch.distributed as dist

            t = torch.tensor([seed], dtype=torch.int64, device=self.device)
            dist.broadcast(t, src=0)
            seed = int(t.item())
        return seed

    def _draw_noise(self, generator: torch.Generator, n_frames: int) -> torch.Tensor:
        """One chunk's ``[n_frames, n_mels]`` sampler noise."""
        return torch.randn((n_frames, self.transformer.mel_dim), generator=generator,
                           device=self.device)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def preprocess_reference(self, ref_audio_path: Optional[str] = None,
                             ref_text: str = "", clip_short: bool = True,
                             ref_audio: Optional[np.ndarray] = None,
                             ref_sample_rate: Optional[int] = None,
                             transcribe_fn=None) -> ReferenceState:
        """Load + clip + RMS-normalise the reference prompt and compute its mel
        on the device (parity: the JAX wrapper's ``preprocess_reference``).
        An empty ``ref_text`` is transcribed through the md5-keyed cache of
        ``infer.utils_infer.transcribe_array_cached`` by
        ``transcribe_fn(path) -> str``; without one it raises, loudly, as the
        byte-ratio duration degrades on zero reference bytes."""
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
            from eraxvif5tts_tpu_torch.infer.utils_infer import transcribe_array_cached

            ref_text = transcribe_array_cached(wav, self.target_sample_rate,
                                               transcribe_fn=transcribe_fn)
        if ref_text and not ref_text.endswith(". ") and not ref_text.endswith("。"):
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
               nfe_step: Optional[int] = None,
               buckets: Optional[tuple[int, ...]] = None,
               text_buckets: Optional[tuple[int, ...]] = None) -> list[tuple[int, int]]:
        """Dispatch the fused step once per reachable (duration bucket, text
        bucket) pair, so that no request pays for the kernel build, the text
        frontend's first call, the allocator's growth or, on the card, the
        pair's graph capture (the JAX wrapper's ``warmup``: same signature,
        loop and result).

        Every duration bucket from ``pick_bucket(ref.n_frames + 1)`` up is
        reachable (``buckets`` narrows them); the text buckets default to the
        range ``generate`` can pick for this reference, from the pinyin token
        counts of the shortest chunk up to a full ``max_chars`` chunk.
        Returns the warmed pairs."""
        ref = ref or self.ref
        if ref is None:
            raise RuntimeError("call preprocess_reference() first or pass ref=")
        convert_char_to_pinyin([ref.text + " warmup."])
        if text_buckets is None:
            max_chars, _ = self._max_chars_for(ref)
            lo = pick_bucket(len(convert_char_to_pinyin([ref.text])[0]) + 2, self.text_buckets)
            hi = pick_bucket(len(convert_char_to_pinyin([ref.text + "x" * max_chars])[0]),
                             self.text_buckets)
            text_buckets = tuple(tb for tb in self.text_buckets if lo <= tb <= hi)
        nfe = nfe_step if nfe_step is not None else self.nfe_step
        vstart = max(ref.n_frames - VOCODE_MARGIN_FRAMES, 0)
        rms_scale = self._rms_scale(ref)
        generator = torch.Generator(device=self.device).manual_seed(0)
        min_bucket = pick_bucket(ref.n_frames + 1, self.duration_buckets)
        warmed = []
        for bucket in buckets or self.duration_buckets:
            if bucket < min_bucket:
                continue  # unreachable: the prompt alone overfills the bucket
            for tb in text_buckets:
                text_ids = np.full((1, tb), -1, np.int64)
                text_ids[0, 0] = 0
                pcm, _ = self._dispatch_sample_vocode(
                    ref.mel, self._device_tensor(text_ids), self._device_tensor([bucket]),
                    self._device_tensor([ref.n_frames]),
                    self._draw_noise(generator, bucket), rms_scale, steps=nfe,
                    cfg_strength=float(self.cfg_strength),
                    sway=(float(self.sway_sampling_coef)
                          if self.sway_sampling_coef is not None else None),
                    max_duration=bucket, vocode_start=vstart, gen_start=ref.n_frames - vstart)
                pcm[:1, :1].cpu()  # until the step has run
                warmed.append((bucket, tb))
        return warmed

    def _max_chars_for(self, ref: ReferenceState) -> tuple[int, int]:
        """Chunking rule: (max_chars, hard cap), as in the JAX wrapper."""
        ref_sec = max(ref.audio_seconds, 1e-3)
        ref_bytes = len(ref.text.encode("utf-8"))
        max_chars = int(ref_bytes / ref_sec * max(22.0 - ref_sec, 1.0))
        bucket_budget = max(self.text_buckets[-1] - ref_bytes - 2, 16)
        return min(max(max_chars, 16), bucket_budget), bucket_budget

    def _duration_for(self, ref: ReferenceState, gen_text: str, speed: float,
                      fix_duration: Optional[float]) -> int:
        """Total frames of one chunk: ``fix_duration`` seconds, else the
        duration predictor's frames over ``speed`` after the prompt (when on
        and it predicts any), else the byte-ratio heuristic."""
        if fix_duration is not None:
            return int(fix_duration * self.target_sample_rate / self.hop_length)
        if self.use_duration_predictor and self.duration_predictor is not None:
            from eraxvif5tts_tpu_torch.models.duration import predict_duration_frames

            frames = predict_duration_frames(self.duration_predictor, self.phoneme_map,
                                             gen_text)
            if frames > 0:
                return ref.n_frames + int(frames / speed)
        return byte_ratio_duration(ref.n_frames, ref.text, gen_text, speed,
                                   hop_length=self.hop_length,
                                   sample_rate=self.target_sample_rate)

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
            self._seed(seed))
        vstart = max(ref.n_frames - VOCODE_MARGIN_FRAMES, 0)
        rms_scale = self._rms_scale(ref)

        waves: list[np.ndarray] = []
        mels: list[np.ndarray] = []
        # As in the JAX wrapper, the host fetches a chunk's PCM only once
        # three more are queued behind it (or at the end), so the card never
        # waits for the host between chunks, and few outputs are held at once.
        pending: list[tuple] = []

        def drain_one():
            pcm, mel, done, n_samples, duration = pending.pop(0)
            if done is not None:
                done.synchronize()
            waves.append(pcm[0, :n_samples].numpy().astype(np.float32) / 32767.0)
            if return_spectrogram:
                mels.append(mel[0, ref.n_frames:duration].T.numpy())

        for chunk in chunks:
            local_speed = 0.3 if len(chunk.encode("utf-8")) < 10 else speed
            full_text = ref.text + chunk
            tokens = convert_char_to_pinyin([full_text]) if use_pinyin else [list(full_text)]
            duration = max(self._duration_for(ref, chunk, local_speed, fix_duration),
                           ref.n_frames + 1)
            bucket = pick_bucket(duration, self.duration_buckets)
            duration = min(duration, bucket)
            text_ids = list_str_to_idx(tokens, self.vocab_char_map,
                                       pad_to=pick_bucket(len(tokens[0]), self.text_buckets))
            pcm, mel = self._dispatch_sample_vocode(
                ref.mel, self._device_tensor(text_ids), self._device_tensor([duration]),
                self._device_tensor([ref.n_frames]), self._draw_noise(generator, bucket),
                rms_scale, steps=nfe_step, cfg_strength=float(cfg_strength),
                sway=float(sway) if sway is not None else None,
                max_duration=bucket, vocode_start=vstart, gen_start=ref.n_frames - vstart)
            pending.append((*self._fetch_async(pcm, mel if return_spectrogram else None),
                            (duration - ref.n_frames) * self.hop_length, duration))
            if len(pending) > 3:
                drain_one()
        while pending:
            drain_one()

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
        ``generate_batch``): one duration bucket and one text bucket for all,
        per-sample durations, the prompt length as every sample's ``lens``,
        one ``[bucket, n_mels]`` noise draw shared by every sample, and each
        wave trimmed to its own duration. Returns one float32 waveform per
        text (no chunking, no cross-fade). On a mesh the batch is padded to a
        multiple of ``data``, each data rank samples its rows, and every rank
        returns the whole list."""
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
            durations.append(max(self._duration_for(ref, text, local_speed, None),
                                 ref.n_frames + 1))
        bucket = pick_bucket(max(durations), self.duration_buckets)
        durations = [min(d, bucket) for d in durations]
        text_ids = list_str_to_idx(token_lists, self.vocab_char_map,
                                   pad_to=pick_bucket(max(map(len, token_lists)),
                                                      self.text_buckets))
        b = len(texts)
        # a mesh's batch: padded to a multiple of `data` (`wrapper.py:771-778`),
        # this data rank's rows
        n_data, rank = pm.axis_size(self.mesh, "data"), pm.axis_rank(self.mesh, "data")
        rows = (b + (-b) % n_data) // n_data
        pad = rows * n_data - b
        text_ids = np.concatenate([text_ids, np.full((pad, text_ids.shape[1]), -1,
                                                     text_ids.dtype)])
        durations_in = durations + [ref.n_frames + 1] * pad
        sl = slice(rank * rows, (rank + 1) * rows)
        generator = torch.Generator(device=self.device).manual_seed(
            self._seed(seed))
        vstart = max(ref.n_frames - VOCODE_MARGIN_FRAMES, 0)
        pcm, _ = self._dispatch_sample_vocode(
            ref.mel.expand(rows, -1, -1), self._device_tensor(text_ids[sl]),
            self._device_tensor(durations_in[sl]), self._device_tensor([ref.n_frames] * rows),
            self._draw_noise(generator, bucket), self._rms_scale(ref), steps=nfe_step,
            cfg_strength=float(cfg_strength), sway=float(sway) if sway is not None else None,
            max_duration=bucket, vocode_start=vstart, gen_start=ref.n_frames - vstart)
        if n_data > 1:
            import torch.distributed as dist

            whole = torch.zeros((rows * n_data, pcm.shape[1]), dtype=torch.float32,
                                device=pcm.device)
            whole[sl] = pcm.float()
            dist.all_reduce(whole, group=pm.axis_group(self.mesh, "data"))
            pcm = whole.to(torch.int16)
        pcm = pcm.cpu().numpy()
        return [pcm[i, :(d - ref.n_frames) * self.hop_length].astype(np.float32) / 32767.0
                for i, d in enumerate(durations)]

    def get_current_audio_length(self) -> float:
        """Seconds of the most recently generated audio."""
        if self._last_wave is None:
            return 0.0
        return len(self._last_wave) / self.target_sample_rate
