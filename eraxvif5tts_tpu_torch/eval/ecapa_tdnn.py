"""ECAPA-TDNN speaker embedder for speaker-similarity (SIM) scoring (port of
`eraxvif5tts_tpu/eval/ecapa_tdnn.py`): the architecture of the reference's
vendored UniSpeech model (`src/f5_tts/eval/ecapa_tdnn.py:1-330`, used by
`utils_eval.py:379-418` as ``ECAPA_TDNN_SMALL(feat_dim=1024, emb_dim=256,
feat_type='wavlm_large')``) as an ``nn.Module`` whose parameter names are the
UniSpeech checkpoint's, so ``state_dict['model']`` loads with a strict
``load_state_dict`` (the WavLM extractor's ``feature_extract.*`` and its
layer weights ``feature_weight`` are left out):

feats [b, t, feat_dim] -> instance-norm -> Conv1dReluBn(k5) -> 3x SE-Res2Block
(k3, dilations 2/3/4, scale 8) -> concat -> 1x1 conv+relu (1536) -> attentive
statistics pooling -> BatchNorm -> Linear(emb_dim).

``ecapa_state_dict_from_jax`` is the inverse of the JAX package's
``ecapa_params_from_torch``: it carries a JAX parameter tree across. The
WavLM-large feature extractor itself is an external model; the offline path
(:func:`make_mel_embed_fn`) runs the head over log-mel (fbank) features.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
SCALE = 8
DILATIONS = (2, 3, 4)
SE_BOTTLENECK = 128
ATTENTION_CHANNELS = 128


class Conv1dReluBn(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel_size, dilation=dilation,
                              padding=dilation * (kernel_size - 1) // 2)
        self.bn = nn.BatchNorm1d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(F.relu(self.conv(x)))


class Res2Conv1dReluBn(nn.Module):
    """`ecapa_tdnn.py:16-52`: scale-1 convs over cumulative chunks; the LAST
    chunk passes through untouched and is appended last."""

    def __init__(self, channels: int, dilation: int, scale: int = SCALE):
        super().__init__()
        width = channels // scale
        self.scale = scale
        self.convs = nn.ModuleList(
            nn.Conv1d(width, width, 3, dilation=dilation, padding=dilation)
            for _ in range(scale - 1))
        self.bns = nn.ModuleList(nn.BatchNorm1d(width, eps=BN_EPS) for _ in range(scale - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.chunk(x, self.scale, dim=1)
        outs, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = chunks[i] if i == 0 else sp + chunks[i]
            sp = bn(F.relu(conv(sp)))
            outs.append(sp)
        outs.append(chunks[-1])
        return torch.cat(outs, dim=1)


class SE_Connect(nn.Module):  # noqa: N801 (the checkpoint's key)
    def __init__(self, channels: int, bottleneck: int = SE_BOTTLENECK):
        super().__init__()
        self.linear1 = nn.Linear(channels, bottleneck)
        self.linear2 = nn.Linear(bottleneck, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.linear1(x.mean(dim=2)))
        return x * torch.sigmoid(self.linear2(s))[:, :, None]


class SE_Res2Block(nn.Module):  # noqa: N801 (the checkpoint's key)
    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.Conv1dReluBn1 = Conv1dReluBn(channels, channels)
        self.Res2Conv1dReluBn = Res2Conv1dReluBn(channels, dilation)
        self.Conv1dReluBn2 = Conv1dReluBn(channels, channels)
        self.SE_Connect = SE_Connect(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.Conv1dReluBn2(self.Res2Conv1dReluBn(self.Conv1dReluBn1(x)))
        return self.SE_Connect(out) + x


class AttentiveStatsPool(nn.Module):
    """`ecapa_tdnn.py:133-160`, ``global_context_att=False``."""

    def __init__(self, channels: int, attention_channels: int = ATTENTION_CHANNELS):
        super().__init__()
        self.linear1 = nn.Conv1d(channels, attention_channels, 1)
        self.linear2 = nn.Conv1d(attention_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = torch.softmax(self.linear2(torch.tanh(self.linear1(x))), dim=2)
        mean = torch.sum(alpha * x, dim=2)
        residuals = torch.sum(alpha * x.square(), dim=2) - mean.square()
        std = torch.sqrt(residuals.clamp(min=1e-9))
        return torch.cat([mean, std], dim=1)


def pooled_channels(channels: int) -> int:
    """The 1x1 conv's output width: the reference hardcodes 1536 at 512
    channels; elsewhere three times ``channels``."""
    return 1536 if channels == 512 else 3 * channels


class ECAPA_TDNN(nn.Module):  # noqa: N801 (the reference's name)
    """The ECAPA-TDNN head. ``forward(feats [b, t, feat_dim])`` -> ``[b, emb_dim]``."""

    def __init__(self, feat_dim: int = 1024, channels: int = 512, emb_dim: int = 256):
        super().__init__()
        pooled = pooled_channels(channels)
        self.layer1 = Conv1dReluBn(feat_dim, channels, kernel_size=5)
        self.layer2 = SE_Res2Block(channels, DILATIONS[0])
        self.layer3 = SE_Res2Block(channels, DILATIONS[1])
        self.layer4 = SE_Res2Block(channels, DILATIONS[2])
        self.conv = nn.Conv1d(3 * channels, pooled, 1)
        self.pooling = AttentiveStatsPool(pooled)
        self.bn = nn.BatchNorm1d(2 * pooled, eps=BN_EPS)
        self.linear = nn.Linear(2 * pooled, emb_dim)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        # InstanceNorm1d(affine=False): per (sample, channel) over time
        x = F.instance_norm(feats.transpose(1, 2), eps=BN_EPS)
        out1 = self.layer1(x)
        out2 = self.layer2(out1)
        out3 = self.layer3(out2)
        out4 = self.layer4(out3)
        x = F.relu(self.conv(torch.cat([out2, out3, out4], dim=1)))
        return self.linear(self.bn(self.pooling(x)))


def ecapa_from_state_dict(sd: dict, device: str | torch.device = "cuda") -> ECAPA_TDNN:
    """The head for a UniSpeech-layout state dict (numpy or torch values;
    ``feature_extract.*`` and ``feature_weight`` ignored), loaded strict, in
    eval mode on ``device``. Its widths are read from the weights."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()
          if not k.startswith("feature_extract.") and k != "feature_weight"}
    channels, feat_dim, _ = sd["layer1.conv.weight"].shape
    model = ECAPA_TDNN(feat_dim, channels, sd["linear.weight"].shape[0])
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# the JAX package's parameter tree (`ecapa_params_from_torch`'s output) back
# to the UniSpeech layout


def _conv_w(kernel) -> np.ndarray:  # [k, in, out] -> torch conv [out, in, k]
    return np.ascontiguousarray(np.asarray(kernel, np.float32).transpose(2, 1, 0))


def _linear_w(kernel) -> np.ndarray:  # [in, out] -> torch linear [out, in]
    return np.ascontiguousarray(np.asarray(kernel, np.float32).T)


def _bn_sd(p: dict, prefix: str) -> dict:
    return {f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"],
            f"{prefix}.running_mean": p["mean"], f"{prefix}.running_var": p["var"],
            f"{prefix}.num_batches_tracked": np.asarray(0, np.int64)}


def _conv_relu_bn_sd(p: dict, prefix: str) -> dict:
    return {f"{prefix}.conv.weight": _conv_w(p["conv_kernel"]),
            f"{prefix}.conv.bias": p["conv_bias"], **_bn_sd(p["bn"], f"{prefix}.bn")}


def ecapa_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The inverse of the JAX ``ecapa_params_from_torch``: a JAX ECAPA
    parameter tree -> the UniSpeech state dict (torch tensors; the
    BatchNorms' ``num_batches_tracked`` at 0)."""
    sd: dict = {**_conv_relu_bn_sd(params["layer1"], "layer1"),
                "conv.weight": _conv_w(params["conv_kernel"]), "conv.bias": params["conv_bias"]}
    for name in ("layer2", "layer3", "layer4"):
        block = params[name]
        sd.update(_conv_relu_bn_sd(block["conv1"], f"{name}.Conv1dReluBn1"))
        for i, (conv, bn) in enumerate(zip(block["res2"]["convs"], block["res2"]["bns"])):
            sd[f"{name}.Res2Conv1dReluBn.convs.{i}.weight"] = _conv_w(conv["kernel"])
            sd[f"{name}.Res2Conv1dReluBn.convs.{i}.bias"] = conv["bias"]
            sd.update(_bn_sd(bn, f"{name}.Res2Conv1dReluBn.bns.{i}"))
        sd.update(_conv_relu_bn_sd(block["conv2"], f"{name}.Conv1dReluBn2"))
        se = block["se"]
        sd.update({f"{name}.SE_Connect.linear1.weight": _linear_w(se["linear1_kernel"]),
                   f"{name}.SE_Connect.linear1.bias": se["linear1_bias"],
                   f"{name}.SE_Connect.linear2.weight": _linear_w(se["linear2_kernel"]),
                   f"{name}.SE_Connect.linear2.bias": se["linear2_bias"]})
        if "shortcut" in block:
            raise ValueError(f"{name} has a shortcut: the reference's ECAPA head has none "
                             "(its blocks keep the width)")
    pool = params["pooling"]
    sd.update({"pooling.linear1.weight": _conv_w(pool["linear1_kernel"]),
               "pooling.linear1.bias": pool["linear1_bias"],
               "pooling.linear2.weight": _conv_w(pool["linear2_kernel"]),
               "pooling.linear2.bias": pool["linear2_bias"],
               **_bn_sd(params["bn"], "bn"),
               "linear.weight": _linear_w(params["linear_kernel"]),
               "linear.bias": params["linear_bias"]})
    if "feature_weight" in params:
        sd["feature_weight"] = params["feature_weight"]
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def load_ecapa_checkpoint(ckpt_path: str, device: str | torch.device = "cuda") -> ECAPA_TDNN:
    """The UniSpeech WavLM-ECAPA checkpoint file (reference
    `utils_eval.py:384-385`: ``torch.load(...)['model']``) as the head on
    ``device``."""
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    return ecapa_from_state_dict(raw.get("model", raw), device)


def init_random_params(rng: np.random.Generator, feat_dim: int = 1024,
                       channels: int = 512, emb_dim: int = 256) -> dict[str, torch.Tensor]:
    """Random weights in the UniSpeech layout, the JAX package's draws in its
    order (the same ``rng`` gives the tree ``ecapa_state_dict_from_jax`` maps
    back to this state dict) — for offline pipeline tests (shapes identical
    to the real checkpoint)."""
    sd: dict[str, np.ndarray] = {}

    def conv(prefix, cin, cout, k):
        sd[f"{prefix}.weight"] = rng.standard_normal((cout, cin, k)).astype(np.float32) * 0.05
        sd[f"{prefix}.bias"] = np.zeros(cout, np.float32)

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = np.ones(c, np.float32)
        sd[f"{prefix}.bias"] = np.zeros(c, np.float32)
        sd[f"{prefix}.running_mean"] = np.zeros(c, np.float32)
        sd[f"{prefix}.running_var"] = np.ones(c, np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)

    def crb(prefix, cin, cout, k):
        conv(f"{prefix}.conv", cin, cout, k)
        bn(f"{prefix}.bn", cout)

    crb("layer1", feat_dim, channels, 5)
    width = channels // SCALE
    for name in ("layer2", "layer3", "layer4"):
        crb(f"{name}.Conv1dReluBn1", channels, channels, 1)
        crb(f"{name}.Conv1dReluBn2", channels, channels, 1)
        for i in range(SCALE - 1):
            conv(f"{name}.Res2Conv1dReluBn.convs.{i}", width, width, 3)
            bn(f"{name}.Res2Conv1dReluBn.bns.{i}", width)
        sd[f"{name}.SE_Connect.linear1.weight"] = (
            rng.standard_normal((SE_BOTTLENECK, channels)).astype(np.float32) * 0.05)
        sd[f"{name}.SE_Connect.linear1.bias"] = np.zeros(SE_BOTTLENECK, np.float32)
        sd[f"{name}.SE_Connect.linear2.weight"] = (
            rng.standard_normal((channels, SE_BOTTLENECK)).astype(np.float32) * 0.05)
        sd[f"{name}.SE_Connect.linear2.bias"] = np.zeros(channels, np.float32)
    pooled = pooled_channels(channels)
    conv("conv", 3 * channels, pooled, 1)
    conv("pooling.linear1", pooled, ATTENTION_CHANNELS, 1)
    conv("pooling.linear2", ATTENTION_CHANNELS, pooled, 1)
    bn("bn", pooled * 2)
    sd["linear.weight"] = rng.standard_normal((emb_dim, pooled * 2)).astype(np.float32) * 0.05
    sd["linear.bias"] = np.zeros(emb_dim, np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def make_mel_embed_fn(state_dict: Optional[dict] = None, ckpt_path: Optional[str] = None,
                      sample_rate: int = 16000, n_mels: int = 80,
                      device: str | torch.device = "cuda") -> Callable:
    """Build an ``embed_fn(wav_path) -> np.ndarray`` over log-mel (fbank)
    features, the mel and the head on ``device``.

    The reference scores over WavLM-large hidden states (feat_dim 1024) — that
    extractor is an external model; this offline path runs the identical ECAPA
    head over log-fbank features (n_fft 512, hop 160, win 400). Pass
    ``ckpt_path`` (UniSpeech layout) or a ``state_dict``; with neither, weights
    are random (pipeline smoke tests only).
    """
    from eraxvif5tts_tpu_torch.audio.io import read_wav
    from eraxvif5tts_tpu_torch.audio.resample import resample
    from eraxvif5tts_tpu_torch.ops.stft import MelSpectrogram

    device = torch.device(device)
    if ckpt_path is not None:
        model = load_ecapa_checkpoint(ckpt_path, device)
    else:
        if state_dict is None:
            state_dict = init_random_params(np.random.default_rng(0), feat_dim=n_mels)
        model = ecapa_from_state_dict(state_dict, device)
    mel_fn = MelSpectrogram(n_fft=512, hop_length=160, win_length=400,
                            n_mel_channels=n_mels, target_sample_rate=sample_rate)

    @torch.inference_mode()
    def embed_fn(wav_path: str) -> np.ndarray:
        wav, sr = read_wav(wav_path)
        wav = wav.mean(axis=0)
        if sr != sample_rate:
            wav = resample(wav, sr, sample_rate)
        feats = mel_fn(torch.from_numpy(np.ascontiguousarray(wav[None], np.float32))
                       .to(device)).transpose(1, 2)  # [1, t, n_mels]
        return model(feats)[0].cpu().numpy()

    return embed_fn
