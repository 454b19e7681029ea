#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device  -- require a CUDA device; print `nvidia-smi`'s name and power limit;
2. build   -- build the CUDA kernels from `eraxvif5tts_tpu_torch/csrc/` with
              nvcc and print the build time and ptxas' resource report;
3. kernels -- each kernel against its plain PyTorch version on the card at the
              serving shapes, with its tolerance and median CUDA-event times;
4. main    -- `F5TTSWrapper` at F5TTS_v1_Base width (dim 1024, depth 22,
              16 x 64 heads) in bf16 from seeded random weights: the DiT with
              its kernels against the same DiT with the plain versions, then
              `preprocess_reference` of the bundled clip and `generate` of three
              texts at NFE 32, with the launch counters checked per chunk and
              the realtime factor printed;
5. server  -- the socket server on a free localhost port answers three
              requests and shuts down.

The line before the last is a JSON object with each kernel's launches in the
main phase, error and times; the last line is the device summary.
"""

from __future__ import annotations

import json
import socket
import statistics
import string
import subprocess
import sys
import threading
import time
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
NFE = 32
WEIGHT_STD = 0.02
TOL = 1.6e-2  # |kernel - plain| <= TOL * (1 + |plain|): a few bf16 ulps
DIT_TOL = 5e-2  # whole-DiT relative error, bf16 through 22 blocks
TEXTS = (
    "Tonight the sea was calm, and the lamp turned steadily.",
    "Not a single ship passed the point. Tomorrow the supply boat arrives, "
    "and the long quiet week will finally be over.",
    "The keeper wrote one more line in the logbook before the dawn came up.",
)


def log(*args):
    print(*args, flush=True)


def cuda_median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name: str, got, want) -> float:
    import torch

    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = TOL * (1 + want.float().abs())
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    if not torch.all(err <= bound):
        raise AssertionError(f"{name}: max |kernel - plain| {float(err.max()):.4g} beyond "
                             f"{TOL} * (1 + |plain|)")
    return float(err.max())


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; TF32 off for fp32 matmuls and convolutions")
    log(smi)
    return smi


def phase_build():
    from eraxvif5tts_tpu_torch.ops import _cuda

    kernels = _cuda.kernels()
    log(f"[build] nvcc {'built' if kernels.built else 'cached'} {kernels.path.name} "
        f"in {kernels.seconds:.2f} s")
    for line in kernels.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")


def phase_kernels(dev) -> dict:
    import torch

    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    err_max, times = 0.0, {}
    for n in (256, 1088, 4096):
        q, k, v = (torch.randn((2, n, 16, 64), generator=g, device=dev).bfloat16()
                   for _ in range(3))
        lens = torch.tensor([n - 37, 0], device=dev)
        rope = rotary_freqs(n, 64, device=dev)
        err = compare(f"serving_attention n={n}", sa.serving_attention(q, k, v, lens, rope),
                      sa.serving_attention_reference(q, k, v, lens, rope))
        err_max = max(err_max, err)
        ms = cuda_median_ms(lambda: sa.serving_attention(q, k, v, lens, rope))
        plain_ms = cuda_median_ms(lambda: sa.serving_attention_reference(q, k, v, lens, rope))
        times[n] = (ms, plain_ms)
        log(f"[kernels] serving_attention b=2 n={n} h=16 d=64 lens=[{n - 37}, 0]: "
            f"max_abs_err {err:.3g} (tol {TOL} * (1 + |plain|)); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
    results["serving_attention"] = dict(max_abs_err=err_max, ms=times[1088][0],
                                        plain_ms=times[1088][1])

    err_max, times = 0.0, {}
    for m in (256, 1088):
        x = (torch.randn((2, m, 1024), generator=g, device=dev) + 0.5).bfloat16()
        scale = (0.1 * torch.randn((2, 1024), generator=g, device=dev)).bfloat16()
        shift = (0.1 * torch.randn((2, 1024), generator=g, device=dev)).bfloat16()
        w = (torch.randn((2048, 1024), generator=g, device=dev) / 32).bfloat16()
        bias = (0.1 * torch.randn((2048,), generator=g, device=dev)).bfloat16()
        args = (x, scale, shift, w, bias)
        err = compare(f"ln_mod_matmul M={m}", fm.ln_mod_matmul(*args),
                      fm.ln_mod_matmul_reference(*args))
        err_max = max(err_max, err)
        ms = cuda_median_ms(lambda: fm.ln_mod_matmul(*args))
        plain_ms = cuda_median_ms(lambda: fm.ln_mod_matmul_reference(*args))
        times[m] = (ms, plain_ms)
        log(f"[kernels] ln_mod_matmul B=2 M={m} K=1024 N=2048 gelu_tanh: max_abs_err "
            f"{err:.3g} (tol {TOL} * (1 + |plain|)); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results["ln_mod_matmul"] = dict(max_abs_err=err_max, ms=times[1088][0],
                                    plain_ms=times[1088][1])
    log("[kernels] the JSON line's ms / plain_ms are the n = M = 1088 bucket's")
    return results


def build_wrapper(dev):
    import torch

    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    chars = " " + string.ascii_letters + string.digits + string.punctuation
    vocab = {c: i for i, c in enumerate(chars)}
    t0 = time.perf_counter()
    wrapper = F5TTSWrapper(model_name="F5TTS_v1_Base", vocab_char_map=vocab, device=dev,
                           compute_dtype="bfloat16", nfe_step=NFE)
    # every leaf from a seeded normal: the reference's zero-initialised AdaLN
    # and output projections would make each block an identity
    g = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        for module in (wrapper.transformer, wrapper.vocoder):
            for p in module.parameters():
                p.normal_(0.0, WEIGHT_STD, generator=g)
    torch.cuda.synchronize()
    a = wrapper.config.arch
    n_params = sum(p.numel() for p in wrapper.transformer.parameters())
    log(f"[main] F5TTS_v1_Base dim {a.dim} depth {a.depth} heads {a.heads}x{a.dim_head} "
        f"ff_mult {a.ff_mult} text_dim {a.text_dim} conv_layers {a.conv_layers}: "
        f"{n_params / 1e6:.1f} M DiT params, bf16, N(0, {WEIGHT_STD}) seed {SEED}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    return wrapper


def check_dit_against_plain(wrapper, dev):
    """One DiT.run at full width with the kernels vs with the plain versions,
    on the same card and inputs."""
    import torch

    from eraxvif5tts_tpu_torch.models import modules
    from eraxvif5tts_tpu_torch.ops.fused_matmul import ln_mod_matmul_reference
    from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
    from eraxvif5tts_tpu_torch.ops.serving_attention import serving_attention_reference

    dit = wrapper.transformer
    n, b = 256, 2
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((b, n, 100), generator=g, device=dev)
    cond = torch.randn((b, n, 100), generator=g, device=dev)
    text = torch.randint(0, 90, (b, 120), generator=g, device=dev)
    drop = torch.tensor([False, True], device=dev)
    mask = lens_to_mask(torch.tensor([n, 200], device=dev), n)
    time_ = torch.tensor([0.3, 0.3], device=dev)

    def run():
        with torch.inference_mode():
            te = dit.embed_text(text, n, drop)
            return dit.run(x, cond, te, time_, drop, mask)

    got = run()
    saved = modules.dot_product_attention, modules.ln_mod_matmul
    modules.dot_product_attention = lambda q, k, v, key_valid=None, rope=None: (
        serving_attention_reference(q, k, v, key_valid.sum(-1), rope))
    modules.ln_mod_matmul = lambda x, s, sh, w, bias, activation="gelu_tanh": (
        ln_mod_matmul_reference(x, s, sh, w, bias, activation))
    try:
        want = run()
    finally:
        modules.dot_product_attention, modules.ln_mod_matmul = saved
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"[main] DiT.run b={b} n={n} kernels vs plain versions: max error {rel:.3g} of "
        f"scale {float(want.abs().max()):.3g} (tol {DIT_TOL})")
    if not torch.isfinite(got).all() or rel > DIT_TOL:
        raise AssertionError(f"DiT with kernels differs from plain by {rel:.3g}")


def phase_main(dev) -> tuple[object, object, dict]:
    import numpy as np
    import torch

    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa

    wrapper = build_wrapper(dev)
    check_dit_against_plain(wrapper, dev)

    example = ROOT / "eraxvif5tts_tpu" / "infer" / "examples" / "basic"
    ref_text = tomllib.loads((example / "basic.toml").read_text())["ref_text"]
    ref = wrapper.preprocess_reference(str(example / "basic_ref_en.wav"), ref_text)
    log(f"[main] reference: {ref.n_frames} frames ({ref.audio_seconds:.2f} s), "
        f"text {ref.text!r}")
    t0 = time.perf_counter()
    wrapper.warmup(ref)
    log(f"[main] warmup (one NFE-{NFE} step at the smallest bucket) "
        f"{time.perf_counter() - t0:.2f} s")

    buckets = []
    sample_vocode = wrapper._sample_vocode

    def counted(*args, **kwargs):
        buckets.append(kwargs["max_duration"])
        return sample_vocode(*args, **kwargs)

    wrapper._sample_vocode = counted
    depth = wrapper.config.arch.depth
    sa.serving_attention.launches = 0
    fm.ln_mod_matmul.launches = 0
    total_audio = total_wall = 0.0
    for i, text in enumerate(TEXTS):
        n_before = len(buckets)
        a0, l0 = sa.serving_attention.launches, fm.ln_mod_matmul.launches
        t0 = time.perf_counter()
        wave = wrapper.generate(text, seed=SEED + i)
        wall = time.perf_counter() - t0
        chunks = len(buckets) - n_before
        audio = len(wave) / wrapper.target_sample_rate
        total_audio, total_wall = total_audio + audio, total_wall + wall
        d_attn = sa.serving_attention.launches - a0
        d_ln = fm.ln_mod_matmul.launches - l0
        log(f"[main] generate #{i}: {chunks} chunk(s) at buckets {buckets[n_before:]}, "
            f"{audio:.2f} s of audio in {wall:.3f} s (RTF {wall / audio:.4f}, "
            f"{audio / wall:.2f}x realtime); launches attention {d_attn}, ln_mod {d_ln}")
        if not (np.isfinite(wave).all() and np.abs(wave).max() > 1e-3 and len(wave) > 0):
            raise AssertionError(f"generate #{i}: PCM is not finite and non-silent")
        want = depth * NFE * chunks
        if d_attn != want or d_ln != want:
            raise AssertionError(f"generate #{i}: launches {d_attn}/{d_ln}, expected "
                                 f"{depth} x {NFE} x {chunks} = {want}")
    wrapper._sample_vocode = sample_vocode
    launches = {"serving_attention": sa.serving_attention.launches,
                "ln_mod_matmul": fm.ln_mod_matmul.launches}
    log(f"[main] {len(TEXTS)} requests: {total_audio:.2f} s of audio in {total_wall:.3f} s: "
        f"RTF {total_wall / total_audio:.4f} ({total_audio / total_wall:.2f}x realtime) at "
        f"NFE {NFE}, bf16, batch 1")
    return wrapper, ref, launches


def phase_server(wrapper, ref):
    import numpy as np

    from eraxvif5tts_tpu_torch.serving.socket_server import TTSStreamingProcessor, start_server

    processor = TTSStreamingProcessor(wrapper, ref_state=ref, nfe_step=NFE,
                                      output_file=None, warm_up=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    stop, ready = threading.Event(), threading.Event()
    server = threading.Thread(target=start_server, args=("127.0.0.1", port, processor),
                              kwargs=dict(stop=stop, ready=ready))
    server.start()
    try:
        if not ready.wait(60):
            raise AssertionError("socket server did not start")
        for i, text in enumerate(TEXTS):
            t0 = time.perf_counter()
            with socket.create_connection(("127.0.0.1", port), timeout=600) as conn:
                conn.sendall(text.encode("utf-8"))
                buf, first = b"", None
                while not buf.endswith(b"END"):
                    data = conn.recv(1 << 16)
                    if not data:
                        raise AssertionError(f"request {i}: connection closed before END")
                    first = first or time.perf_counter() - t0
                    buf += data
            pcm = np.frombuffer(buf[:-3], np.float32)
            if len(buf[:-3]) % 4 or not len(pcm) or not np.isfinite(pcm).all():
                raise AssertionError(f"request {i}: malformed float32 stream")
            log(f"[server] request #{i}: {len(pcm) / 24000:.2f} s of float32 audio + END, "
                f"first bytes after {first:.3f} s, done in {time.perf_counter() - t0:.3f} s")
    finally:
        stop.set()
        server.join(timeout=120)
    if server.is_alive():
        raise AssertionError("socket server did not shut down")
    log("[server] shut down")


def main() -> int:
    if not (ROOT / "eraxvif5tts_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(eraxvif5tts_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernel_results = phase_kernels(dev)
    wrapper, ref, launches = phase_main(dev)
    phase_server(wrapper, ref)
    kernels = [
        dict(name="serving_attention", route="cuda",
             source="eraxvif5tts_tpu_torch/csrc/serving_attention.cu",
             replaces="eraxvif5tts_tpu/ops/serving_attention.py:121",
             launches=launches["serving_attention"], **kernel_results["serving_attention"]),
        dict(name="ln_mod_matmul", route="cuda",
             source="eraxvif5tts_tpu_torch/csrc/ln_mod_matmul.cu",
             replaces="eraxvif5tts_tpu/ops/fused_matmul.py:68",
             launches=launches["ln_mod_matmul"], **kernel_results["ln_mod_matmul"]),
    ]
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
