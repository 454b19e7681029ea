"""One warm `generate` per backbone and dtype with the fused step as one CUDA
graph replay a chunk, beside the same request with the eager step, on one
card.

    python3 eraxvif5tts_tpu_torch/tools/profile_dispatch.py [--nfe 32] [--repeats 3]

For F5TTS_v1_Base (the DiT), E2TTS_Base (the UNetT) and F5TTS_v1_MMDiT at
full width and depth, in bf16 and in fp32, from seeded N(0, 0.02) weights
(`chip_smoke.randomize`) and the bundled reference clip, `generate` of the
smoke's second text at NFE 32. Each wrapper runs the text once to capture its
keys (that call's wall is the first use's cost), then ``--repeats`` calls are
timed (median wall) and one more runs under `torch.profiler`: its device
kernels' time, their number, the host's `cudaGraphLaunch` calls, the device's
busy share of the median wall and the bytes of the wrapper's graph pool. Then
the same with `F5TTSWrapper._sample_vocode` dispatched eagerly in place of the
graphs (a warm call first), and the PCM of both compared. One line a row,
after the card's name and power limit; `chip_smoke.py` is imported from the
checkout for its helpers.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MODELS = ("F5TTS_v1_Base", "E2TTS_Base", "F5TTS_v1_MMDiT")


def measure(wrapper, text: str, nfe: int, repeats: int, graphs: bool) -> dict:
    """Walls and a profiled pass of ``generate(text)``, through the graphs or
    through the eager step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    if not graphs:
        wrapper._dispatch_sample_vocode = wrapper._sample_vocode

    def call():
        out = wrapper.generate(text, seed=cs.SEED, nfe_step=nfe)
        torch.cuda.synchronize()
        return out

    try:
        t0 = time.perf_counter()
        wave = call()
        first = time.perf_counter() - t0
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            call()
            walls.append(time.perf_counter() - t0)
        replays = wrapper.graph_replays
        # the host's events only with graphs: eager steps launch tens of
        # thousands of kernels, whose host records slow the pass severalfold
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if graphs else [])
        with profile(activities=activities) as prof:
            call()
        chunks = wrapper.graph_replays - replays
    finally:
        if not graphs:
            del wrapper._dispatch_sample_vocode
    groups, kernels = cs.device_ms_by_group(prof)
    wall = statistics.median(walls)
    device_ms = sum(groups.values())
    return dict(wave=np.asarray(wave), first_s=first, wall_ms=1e3 * wall,
                walls=[round(w, 4) for w in walls], device_ms=device_ms,
                busy=100 * device_ms / (1e3 * wall), kernels=kernels, chunks=chunks,
                graph_launches=sum(e.count for e in prof.key_averages()
                                   if e.key == "cudaGraphLaunch"),
                audio_s=len(wave) / wrapper.target_sample_rate)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nfe", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--models", nargs="*", default=list(MODELS))
    ap.add_argument("--dtypes", nargs="*", default=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.tools.bench import card_line

    print(f"card: {card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    vocab = {c: i for i, c in enumerate(cs.VOCAB_CHARS)}
    text = cs.TEXTS[1]
    for model in args.models:
        for dtype in args.dtypes:
            t0 = time.perf_counter()
            wrapper = F5TTSWrapper(model, vocab_char_map=vocab, device=dev, compute_dtype=dtype,
                                   nfe_step=args.nfe)
            cs.randomize((wrapper.transformer, wrapper.vocoder), cs.SEED)
            cs.load_reference(wrapper)
            built = time.perf_counter() - t0
            graph = measure(wrapper, text, args.nfe, args.repeats, graphs=True)
            pool = cs.graph_pool_bytes(wrapper)
            eager = measure(wrapper, text, args.nfe, args.repeats, graphs=False)
            same = np.array_equal(graph["wave"], eager["wave"])
            print(f"{model} {dtype} (built in {built:.1f} s): generate of {len(text)} chars, "
                  f"{graph['audio_s']:.2f} s of audio in {graph['chunks']} chunk(s), NFE "
                  f"{args.nfe}", flush=True)
            print(f"  graphs: first call {graph['first_s']:.3f} s (capture of "
                  f"{len(wrapper._graphs)} key(s)); warm wall {graph['wall_ms']:.1f} ms "
                  f"(median of {graph['walls']} s), device {graph['device_ms']:.1f} ms = "
                  f"{graph['busy']:.1f} % busy, {graph['kernels']} device kernels, "
                  f"{graph['graph_launches']} cudaGraphLaunch for {graph['chunks']} chunk(s), "
                  "graph pool " + (f"{pool / 2**20:.1f} MiB" if pool is not None
                                   else "not measured"), flush=True)
            print(f"  eager:  warm wall {eager['wall_ms']:.1f} ms (median of {eager['walls']} "
                  f"s), device {eager['device_ms']:.1f} ms = {eager['busy']:.1f} % busy, "
                  f"{eager['kernels']} device kernels; wall eager / graphs "
                  f"{eager['wall_ms'] / graph['wall_ms']:.2f}x; PCM equal bit for bit: {same}",
                  flush=True)
            del wrapper
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
