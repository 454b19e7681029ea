"""Benchmark: real-time factor of the zero-shot cloning step, the port's
counterpart of the JAX package's `bench.py`.

    python3 eraxvif5tts_tpu_torch/tools/bench.py [--dtype bfloat16] [--device cuda]
    python3 eraxvif5tts_tpu_torch/tools/bench.py --smoke --device cpu

The workload is `bench.py`'s: a random `F5TTS_v1_Base` (seeded PyTorch
initialisation, 2546 text tokens) with Vocos; a 1024-frame duration bucket
with a 256-frame prompt, 96 text ids in a 128-id text bucket; NFE 32, CFG 2,
sway -1; one warm-up call, then the median wall of ``--iters`` calls. A call
is what `F5TTSWrapper.generate` makes of one chunk: the fused
sample-and-vocode dispatch (`F5TTSWrapper._dispatch_sample_vocode`: on the
card one CUDA graph replay, captured by the warm-up; on the CPU the eager
step), then the fetch of its int16 PCM to the host. The last line is the one
JSON object `bench.py` prints:

    {"metric": "rtf_nfe32", "value": <audio_s / wall_s>, "unit": "x_realtime",
     "vs_baseline": <value / 20.0>}

with 20x realtime the target of BASELINE.md. Earlier lines give the card's
name and power limit, the warm-up call's wall (the key's graph capture
included) and every timed call's. ``--smoke`` runs `bench.py`'s tiny model on
small buckets, for the CPU (its head dim, 32, is outside the card's
attention kernel).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_TEXT_TOKENS = 2546  # the published vocabulary's size, as `bench.py` builds the DiT


def build(smoke: bool, dtype: str, device: str):
    """The wrapper: random weights from ``torch.manual_seed(0)``."""
    import torch

    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.models.vocos import Vocos

    cfg = PRESETS["F5TTS_v1_Base"]
    if smoke:
        cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
            cfg.arch, dim=64, depth=2, heads=2, dim_head=32, text_dim=32, conv_layers=1))
    torch.manual_seed(0)
    wrapper = F5TTSWrapper(model_cfg=cfg, compute_dtype=dtype, device=device,
                           vocab_char_map={str(i): i for i in range(N_TEXT_TOKENS)})
    if smoke:
        mel = cfg.mel_spec
        wrapper.vocoder = Vocos(input_channels=mel.n_mel_channels, dim=64, intermediate_dim=128,
                                num_layers=2, compute_dtype=wrapper.vocoder.compute_dtype
                                ).to(wrapper.device).eval()
    return cfg, wrapper


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi` prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="tiny model, CPU-safe")
    ap.add_argument("--nfe", type=int, default=32)
    ap.add_argument("--bucket", type=int, default=None, help="total mel frames")
    ap.add_argument("--ref-frames", type=int, default=None)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)

    import torch

    bucket = args.bucket or (128 if args.smoke else 1024)
    ref_frames = args.ref_frames or (32 if args.smoke else 256)
    cfg, wrapper = build(args.smoke, args.dtype, args.device)
    dev = wrapper.device
    hop, sr = cfg.mel_spec.hop_length, cfg.mel_spec.target_sample_rate
    if dev.type == "cuda":
        print(f"card: {card_line()}", flush=True)

    g = torch.Generator(device=dev).manual_seed(2)
    cond = torch.randn((1, ref_frames, cfg.mel_spec.n_mel_channels), generator=g, device=dev)
    text = torch.zeros((1, 128), dtype=torch.long, device=dev)
    text[:, :96] = torch.arange(1, 97, device=dev)
    duration = torch.tensor([bucket], device=dev)
    lens = torch.tensor([ref_frames], device=dev)
    noise = wrapper._draw_noise(torch.Generator(device=dev).manual_seed(3), bucket)
    rms_scale = torch.tensor(1.0, device=dev)

    def run():
        pcm, _ = wrapper._dispatch_sample_vocode(
            cond, text, duration, lens, noise, rms_scale, steps=args.nfe, cfg_strength=2.0,
            sway=-1.0, max_duration=bucket, vocode_start=0, gen_start=0)
        return pcm.cpu()  # the fetch that ends a chunk

    t0 = time.perf_counter()
    run()
    first = time.perf_counter() - t0
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    audio_seconds = (bucket - ref_frames) * hop / sr
    rtf = audio_seconds / wall
    a = wrapper.config.arch
    print(f"F5TTS_v1_Base{' (smoke: tiny)' if args.smoke else ''} dim {a.dim} depth {a.depth} "
          f"{args.dtype} on {dev}: bucket {bucket}, prompt {ref_frames} frames, NFE {args.nfe}; "
          f"{len(wrapper._graphs)} CUDA graph(s), {wrapper.graph_replays} replay(s); warm-up "
          f"call {first:.4f} s; timed calls (s): {' '.join(f'{t:.4f}' for t in times)}; "
          f"median {wall:.4f} s for {audio_seconds:.3f} s of audio", flush=True)
    print(json.dumps({
        "metric": "rtf_nfe32" if args.nfe == 32 else f"rtf_nfe{args.nfe}",
        "value": round(rtf, 3),
        "unit": "x_realtime",
        "vs_baseline": round(rtf / 20.0, 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
