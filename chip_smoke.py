#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device  -- require a CUDA device; print `nvidia-smi`'s name and power limit;
2. build   -- build the CUDA kernels from `eraxvif5tts_tpu_torch/csrc/` with
              nvcc and print the build time and ptxas' resource report;
3. kernels -- each kernel against its plain PyTorch version on the card at the
              serving and training shapes, with its tolerance, median
              CUDA-event times, the least time the card could take for the
              same inputs (bytes and operations over the H100's published
              peaks) and, where one PyTorch call computes the same function,
              that call's time as a yardstick (the serving attention with and
              without fused rotary; the normalised projection in its
              layernorm and RMS modes; the training attention forward and both
              backward kernels against the plain version's autograd, also
              at the train phase's 9 x 4096 shape, each limit checked
              against a wrong-seed control; the int8 feed-forward also at
              the batched CFG shape, with its hidden codes compared; the
              gated residual projection, which no model calls, masked and
              unmasked);
4. main    -- `F5TTSWrapper` at F5TTS_v1_Base width (dim 1024, depth 22,
              16 x 64 heads) in bf16 from seeded random weights: the DiT with
              its kernels against the same DiT with the plain versions, then
              `preprocess_reference` of the bundled clip and `generate` of three
              texts at NFE 32, with the launch counters checked per chunk and
              the realtime factor printed, and one more under `torch.profiler`
              (device time by kernel group, the device's busy share of the
              wall); then F5TTS_Base's options (rotary
              on head 0 only, unmasked text padding) on a DiT cut to 4 blocks:
              kernels against plain, one `generate` at NFE 8, counters checked;
5. server  -- the socket server on a free localhost port answers three
              requests and shuts down;
6. int8    -- int8 W8A8 serving at the same width: a seeded N(0, 0.02)
              reference-format checkpoint, `F5TTSWrapper(compute_dtype="int8",
              int8_validate=True)` quantizing it at load behind the quality
              gate, then `generate_batch` of eight texts (warm-up at NFE 2),
              the quantized DiT with its kernels against the plain versions
              and the int8 feed-forward against its plain version, both at
              the shape that batch gives them, then the batch at NFE 32 with
              the QuantLinear chain (`ERAX_INT8_FF` unset) and with the
              one-kernel feed-forward (`ERAX_INT8_FF=1`), in turns with a
              bf16 wrapper on the same checkpoint, with the launch counters
              checked per call and seconds of audio per wall second printed;
7. train   -- CFM training of F5TTS_v1_Base at full width (fp32 parameters,
              bf16 compute, dropout 0.1, seeded random weights): one
              `CFM.loss` forward and backward with the kernels against the
              plain attention (and a wrong-mask control), then `Trainer.train_step` on the single-chip
              reference batch (9 x 4096 frames, blocks checkpointed) for three
              steps at dropout 0.1 and one at dropout 0, with the launch
              counters checked per step, and a checkpoint save / restore;
8. e2tts   -- E2-TTS serving at E2TTS_Base width and depth (UNetT: dim 1024,
              24 layers, 16 x 64 heads, ff_mult 4, rotary on head 0 only) in
              bf16: a seeded N(0, 0.02) reference-format checkpoint (norm gains
              1 + N(0, 0.02)) loaded through the port's converter, the UNetT
              with its kernels against the plain versions, `generate` of the
              three texts at NFE 32 with the launch counters checked per chunk
              (the attention kernel without fused rotary and the projection
              kernel in RMS mode, 24 x 32 each, counted apart from the rotary
              and layernorm launches), a profiled request as in the main
              phase, then one socket-server request.

The line before the last is a JSON object with each kernel's launches in its
path's phase (serving kernels with fused rotary / layernorm: main; without
rotary / RMS: e2tts; int8 feed-forward: int8; training kernels: train; the
gated residual projection, on no path: kernels), error, times, bound and
library time; the last line is the device summary.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import socket
import statistics
import string
import subprocess
import sys
import tempfile
import threading
import time
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
NFE = 32
WEIGHT_STD = 0.02
TOL = 1.6e-2  # |kernel - plain| <= TOL * (1 + |plain|): a few bf16 ulps
DIT_TOL = 5e-2  # whole-backbone relative error, bf16 through 22-24 blocks
BASE_DEPTH, BASE_NFE = 4, 8  # the F5TTS_Base check's cuts
# NVIDIA H100 SXM data sheet, dense: the peaks a kernel's bound is taken against
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12}
# int8 feed-forward, |kernel - plain| in units of max |plain|: both sum exactly
# (int32) and round at the same points in IEEE fp32; a hidden code flipped by
# a tie moves an output by ~1e-3 of it. At most CODE_FLIPS of the hidden codes
# may differ (H100: none; a reciprocal-product scale flipped 6e-4 of them)
INT8_FF_TOL = 1e-2
CODE_FLIPS = 1e-5
# Limits near the geometric mean of the error measured on an H100 and a
# control's distance (the plain version with a wrong dropout seed, or with
# wrong attention-dropout keys), which each run checks to exceed the limit:
ATTN_REL_TOL = 3e-2  # kernel 4's output and gradients, relative L2: <= 3.2e-3 vs >= 0.44
LOSS_TOL = 8e-6  # CFM.loss, kernels vs plain attention, relative: 5.0e-6 vs 1.3e-5
GRAD_TOL = 3.4e-3  # its flattened gradient, relative L2: 2.55e-3 vs 4.5e-3
QKV_GRAD_TOL = 7e-3  # the q / k / v projections' gradient, relative L2: 2.7e-3 vs 1.9e-2
VOCAB_CHARS = " " + string.ascii_letters + string.digits + string.punctuation
TRAIN_BATCH = (9, 4096)  # the single-chip reference batch: 36,864 of 38,400 frames
TRAIN_FRAME_BUDGET = 38400  # frames per chip, `configs` DatasetConfig.batch_size_per_gpu
TRAIN_TEXT = 512  # the text bucket the batch is padded to
TEXTS = (
    "Tonight the sea was calm, and the lamp turned steadily.",
    "Not a single ship passed the point. Tomorrow the supply boat arrives, "
    "and the long quiet week will finally be over.",
    "The keeper wrote one more line in the logbook before the dawn came up.",
)
# the int8 phase's batch: eight utterances of 0.7 to ~5 s of text
BATCH_TEXTS = TEXTS + (
    "Rain tapped on the glass all afternoon.",
    "She folded the map, put it in her coat pocket, and walked down to the harbour.",
    "Five gulls sat on the railing.",
    "The radio crackled twice and then went silent for the rest of the night.",
    "By morning the fog had lifted, and the far island stood out sharp and green.",
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


def bound(nbytes: float, ops: float, kind: str = "bf16") -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the tensor cores' peak for their type, whichever
    is larger."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S[kind] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def attention_work(b: int, n: int, h: int, d: int, lens, rope: bool) -> tuple[float, float]:
    """(bytes, operations) of one serving attention on these inputs: q, k, v
    read and the output written in bf16, the lengths and the fp32 cos / sin
    tables read; QK^T and PV over each sample's valid keys (a sample with no
    valid key averages every key)."""
    keys = sum(n if length <= 0 else min(length, n) for length in lens)
    return (4 * b * n * h * d * 2 + b * 4 + (2 * n * d * 4 if rope else 0),
            4.0 * h * d * n * keys)


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
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    g = torch.Generator(device=dev).manual_seed(SEED)
    # the cases without rotary and in RMS mode draw from a generator of their
    # own, so the rotary and layernorm cases see the inputs they always saw
    # and their errors compare from run to run
    g_new = torch.Generator(device=dev).manual_seed(SEED + 20)
    results = {}

    for name, with_rope in (("serving_attention", True), ("serving_attention_norope", False)):
        err_max, cases, gen = 0.0, {}, g if with_rope else g_new
        for n in (256, 1088, 4096):
            q, k, v = (torch.randn((2, n, 16, 64), generator=gen, device=dev).bfloat16()
                       for _ in range(3))
            lens = torch.tensor([n - 37, 0], device=dev)
            rope = rotary_freqs(n, 64, device=dev) if with_rope else None
            err = compare(f"{name} n={n}", sa.serving_attention(q, k, v, lens, rope),
                          sa.serving_attention_reference(q, k, v, lens, rope))
            err_max = max(err_max, err)
            ms = cuda_median_ms(lambda: sa.serving_attention(q, k, v, lens, rope))
            plain_ms = cuda_median_ms(lambda: sa.serving_attention_reference(q, k, v, lens, rope))
            least = bound(*attention_work(2, n, 16, 64, [n - 37, 0], with_rope))
            library_ms = None
            if not with_rope:
                # the yardstick: one library call on the same q, k, v and key mask
                # (heads second, as it wants them; a view, not a copy)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                key_mask = (torch.arange(n, device=dev)[None] < lens[:, None])[:, None, None, :]
                library_ms = cuda_median_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_mask))
            cases[n] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **least)
            log(f"[kernels] {name} b=2 n={n} h=16 d=64 lens=[{n - 37}, 0] rope "
                f"{'fused' if with_rope else 'None'}: max_abs_err {err:.3g} (tol {TOL} * "
                f"(1 + |plain|)); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{least['bound_ms']:.5f} ms by {least['bound_by']}"
                + (f", library (scaled_dot_product_attention, boolean key mask) "
                   f"{library_ms:.4f} ms" if library_ms is not None else ""))
        results[name] = dict(max_abs_err=err_max, **cases[1088])

    # kernel 2: the layernorm mode at the DiT's FF width, then the RMS mode at
    # the UNetT's (scale = g - 1 with g ~ 1 + 0.1 N(0, 1), shift = 0, one
    # all-zero row, which must come out as act(bias))
    for name, norm, n_out in (("ln_mod_matmul", "ln", 2048), ("ln_mod_matmul_rms", "rms", 4096)):
        err_max, cases, gen = 0.0, {}, g if norm == "ln" else g_new
        for m in (256, 1088):
            x = (torch.randn((2, m, 1024), generator=gen, device=dev) + 0.5).bfloat16()
            scale = (0.1 * torch.randn((2, 1024), generator=gen, device=dev)).bfloat16()
            shift = (0.1 * torch.randn((2, 1024), generator=gen, device=dev)).bfloat16()
            w = (torch.randn((n_out, 1024), generator=gen, device=dev) / 32).bfloat16()
            bias = (0.1 * torch.randn((n_out,), generator=gen, device=dev)).bfloat16()
            if norm == "rms":
                x[1, m // 2] = 0.0
                scale, shift = scale[:1].expand(2, -1).contiguous(), torch.zeros_like(shift)
            args = (x, scale, shift, w, bias)
            got = fm.ln_mod_matmul(*args, norm=norm)
            err = compare(f"{name} M={m}", got, fm.ln_mod_matmul_reference(*args, norm=norm))
            if norm == "rms" and not torch.equal(
                    got[1, m // 2], F.gelu(bias.float(), approximate="tanh").bfloat16()):
                raise AssertionError(f"{name} M={m}: the all-zero row is not gelu(bias)")
            err_max = max(err_max, err)
            ms = cuda_median_ms(lambda: fm.ln_mod_matmul(*args, norm=norm))
            plain_ms = cuda_median_ms(lambda: fm.ln_mod_matmul_reference(*args, norm=norm))
            least = bound(2 * (2 * m * 1024 + 2 * 2 * 1024 + n_out * 1024 + n_out
                               + 2 * m * n_out), 2.0 * 2 * m * 1024 * n_out)
            cases[m] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **least)
            log(f"[kernels] {name} B=2 M={m} K=1024 N={n_out} norm {norm} gelu_tanh: "
                f"max_abs_err {err:.3g} (tol {TOL} * (1 + |plain|)); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {least['bound_ms']:.5f} ms by {least['bound_by']}")
        results[name] = dict(max_abs_err=err_max, **cases[1088])
    log("[kernels] the JSON line's serving ms / plain_ms / bound_ms / library_ms are the "
        "n = M = 1088 bucket's; no single PyTorch call computes kernel 2 or the attention "
        "with rotary, so their library_ms is null")
    results.update(check_int8_ff(dev, g))
    results.update(check_matmul_gate_res(dev, g))
    results.update(check_train_attention(dev, g))
    return results


def int8_chain(x, w1_q, s1, b1, w2_q, s2, b2):
    """The quantized block's unfused feed-forward (`ERAX_INT8_FF` unset): two
    QuantLinear products with bf16 outputs and biases, tanh-GELU in bf16."""
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops.quant import int8_matmul

    h = F.gelu(int8_matmul(x, w1_q, s1) + b1.bfloat16(), approximate="tanh")
    return int8_matmul(h, w2_q, s2) + b2.bfloat16()


def check_int8_ff_shape(dev, g, b: int, m: int, tag: str = "[kernels]") -> tuple:
    """Kernel 5 against its plain version at [b, m, 1024] x 2048 x 1024 (the
    DiT's FF at dim 1024, ff 2048) on seeded operands: the output within
    INT8_FF_TOL of its scale, the hidden codes the kernel requantizes
    compared with the plain version's. Times: kernel, plain version, and the
    QuantLinear chain the model runs without ERAX_INT8_FF. Returns (error,
    kernel ms, plain ms)."""
    import torch

    from eraxvif5tts_tpu_torch.ops import quant, quant_ff

    x = torch.randn((b, m, 1024), generator=g, device=dev).bfloat16()
    w1_q, s1 = quant.quantize_weight(torch.randn((2048, 1024), generator=g, device=dev) / 32)
    w2_q, s2 = quant.quantize_weight(torch.randn((1024, 2048), generator=g, device=dev) / 45)
    b1 = 0.1 * torch.randn((2048,), generator=g, device=dev)
    b2 = 0.1 * torch.randn((1024,), generator=g, device=dev)
    args = (x, w1_q, s1, b1, w2_q, s2, b2)
    codes = torch.empty((b, m, 2048), dtype=torch.int8, device=dev)
    got = quant_ff.int8_ff(*args, h_codes=codes)
    want = quant_ff.int8_ff_reference(*args)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    code_diff = (codes.int() - quant_ff.hidden_codes(*args[:4])[0].int()).abs()
    flipped, worst = int((code_diff > 0).sum()), int(code_diff.max())
    shape = f"B={b} M={m} K=1024 N=2048 K2=1024"
    if not torch.isfinite(got).all() or err > INT8_FF_TOL * scale:
        raise AssertionError(f"int8_ff {shape}: max |kernel - plain| {err:.4g} beyond "
                             f"{INT8_FF_TOL} x {scale:.4g}")
    if worst > 1 or flipped > CODE_FLIPS * codes.numel():
        raise AssertionError(f"int8_ff {shape}: {flipped} hidden codes differ, by up to {worst}")
    ms = cuda_median_ms(lambda: quant_ff.int8_ff(*args))
    plain_ms = cuda_median_ms(lambda: quant_ff.int8_ff_reference(*args))
    chain_ms = cuda_median_ms(lambda: int8_chain(*args))
    log(f"{tag} int8_ff {shape}: max_abs_err {err:.3g} of scale {scale:.3g} (tol "
        f"{INT8_FF_TOL} of scale); hidden codes differing {flipped} of {codes.numel()} "
        f"(max {worst}; tol {CODE_FLIPS} of them, by 1); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, QuantLinear chain {chain_ms:.4f} ms")
    return err, ms, plain_ms


def check_int8_ff(dev, g) -> dict:
    """Kernel 5 at b = 2 (one utterance with CFG) at M = 256 and 1088, and
    at 16 x 1024; the int8 phase adds the shape its batch gives the kernel."""
    cases = {(b, m): check_int8_ff_shape(dev, g, b, m)
             for b, m in ((2, 256), (2, 1088), (16, 1024))}
    rows = 2 * 1088
    # x in and out in bf16, both int8 weight matrices, fp32 scales and biases;
    # two int8 products of rows x 1024 x 2048
    least = bound(2 * rows * 1024 * 2 + 2 * 2048 * 1024 + 2 * (2048 + 1024) * 4,
                  2 * 2.0 * rows * 1024 * 2048, "int8")
    log(f"[kernels] the JSON line's int8_ff ms / plain_ms are the B = 2, M = 1088 case's; its "
        f"bound {least['bound_ms']:.5f} ms by {least['bound_by']} (int8 peak); no single "
        "PyTorch call computes it")
    return {"int8_ff": dict(max_abs_err=max(err for err, _, _ in cases.values()),
                            ms=cases[(2, 1088)][1], plain_ms=cases[(2, 1088)][2],
                            library_ms=None, **least)}


def check_matmul_gate_res(dev, g) -> dict:
    """Kernel 3 against its plain version at the DiT's FF output shape
    ([2, M, 2048] -> 1024), rows past lens kept as the residual and not. No
    model calls it (as in the JAX package), so its launches are this
    check's."""
    import torch

    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm

    fm.matmul_gate_res.launches = 0
    err_max, times = 0.0, {}
    for m in (256, 1088):
        h = torch.randn((2, m, 2048), generator=g, device=dev).bfloat16()
        w = (torch.randn((1024, 2048), generator=g, device=dev) / 45).bfloat16()
        bias = (0.1 * torch.randn((1024,), generator=g, device=dev)).bfloat16()
        gate = torch.randn((2, 1024), generator=g, device=dev).bfloat16()
        res = torch.randn((2, m, 1024), generator=g, device=dev).bfloat16()
        lens = torch.tensor([m, m - 37], dtype=torch.int32, device=dev)
        for mask_rows in (True, False):
            args = (h, w, bias, gate, res, lens, mask_rows)
            got = fm.matmul_gate_res(*args)
            err = compare(f"matmul_gate_res M={m} mask_rows={mask_rows}", got,
                          fm.matmul_gate_res_reference(*args))
            if mask_rows and not torch.equal(got[1, m - 37:], res[1, m - 37:]):
                raise AssertionError(f"matmul_gate_res M={m}: masked rows are not the residual")
            err_max = max(err_max, err)
            ms = cuda_median_ms(lambda: fm.matmul_gate_res(*args))
            plain_ms = cuda_median_ms(lambda: fm.matmul_gate_res_reference(*args))
            times[(m, mask_rows)] = (ms, plain_ms)
            log(f"[kernels] matmul_gate_res B=2 M={m} K=2048 N=1024 mask_rows={mask_rows} "
                f"(lens [{m}, {m - 37}]): max_abs_err {err:.3g} (tol {TOL} * (1 + |plain|)); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    m = 1088
    # h, the weight, bias, gate, the residual in and the output out in bf16, the
    # lengths; the product over the rows below each sample's length
    least = bound(2 * (2 * m * 2048 + 1024 * 2048 + 1024 + 2 * 1024 + 2 * 2 * m * 1024) + 8,
                  2.0 * (m + m - 37) * 2048 * 1024)
    log("[kernels] the JSON line's matmul_gate_res ms / plain_ms are the M = 1088 masked "
        "case's; its launches are the kernel phase's (no model path calls it); its bound "
        f"{least['bound_ms']:.5f} ms by {least['bound_by']}; no single PyTorch call computes it")
    return {"matmul_gate_res": dict(max_abs_err=err_max, ms=times[(1088, True)][0],
                                    plain_ms=times[(1088, True)][1],
                                    launches=fm.matmul_gate_res.launches, library_ms=None,
                                    **least)}


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in fp32."""
    return float((got.float() - want.float()).norm() / want.float().norm())


def attention_grads(fn, q, k, v, dout) -> list:
    """[O, dq, dk, dv] of ``fn(q, k, v)`` under the output gradient ``dout``."""
    import torch

    args = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*args)
    return [out.detach(), *torch.autograd.grad(out, args, dout)]


def plain_attention_grads(q, k, v, dout, lens, rate: float, seed: int) -> list:
    """The plain version's [O, dq, dk, dv], one sample at a time with its
    batch index in the dropout salt: the dense fp32 [b, h, n, n] logits of a
    whole 9 x 4096 batch would not fit on the card."""
    import torch

    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    def sample(i):
        li = None if lens is None else lens[i:i + 1]
        return attention_grads(
            lambda *a: ta.train_attention_reference(*a, li, rate, seed, batch_offset=i),
            q[i:i + 1], k[i:i + 1], v[i:i + 1], dout[i:i + 1])

    return [torch.cat(parts) for parts in zip(*(sample(i) for i in range(q.shape[0])))]


def check_train_attention_case(q, k, v, dout, lens, rate: float, seed: int) -> dict:
    """Kernel-4 output and gradients against the plain version on one input:
    each within ``TOL * (1 + |plain|)`` element by element and within
    ``ATTN_REL_TOL`` relative L2 error. At dropout > 0 the plain version with
    the next seed is the control: its relative L2 distance from the plain
    version must exceed ``ATTN_REL_TOL``, or the check could not see a wrong
    mask. A second forward with the same seed must be bit-identical. Returns
    the largest elementwise error, the relative errors and the controls."""
    import torch

    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask

    b, n = q.shape[:2]
    mask = None if lens is None else lens_to_mask(lens, n)

    def kernel(*a):
        return ta.train_attention(*a, key_valid=mask, dropout_rate=rate, seed=seed)

    got = attention_grads(kernel, q, k, v, dout)
    want = plain_attention_grads(q, k, v, dout, lens, rate, seed)
    tag = f"b={b} n={n} dropout {rate}"
    names = ("fwd", "dq", "dk", "dv")
    abs_err = {name: compare(f"train_attention {name} {tag}", g, w)
               for name, g, w in zip(names, got, want)}
    rel = {name: rel_l2(g, w) for name, g, w in zip(names, got, want)}
    control = {}
    if rate > 0.0:
        wrong = plain_attention_grads(q, k, v, dout, lens, rate, seed + 1)
        control = {name: rel_l2(c, w) for name, c, w in zip(names, wrong, want)}
    log(f"[kernels] train_attention {tag}: relative L2 error "
        + ", ".join(f"{name} {rel[name]:.3g}" for name in names)
        + f" (tol {ATTN_REL_TOL}); max_abs_err "
        + ", ".join(f"{name} {abs_err[name]:.3g}" for name in names)
        + (("; control (plain, next seed) " + ", ".join(f"{name} {control[name]:.3g}"
                                                          for name in names)) if control else ""))
    for name in names:
        if rel[name] > ATTN_REL_TOL:
            raise AssertionError(f"train_attention {name} {tag}: relative L2 error "
                                 f"{rel[name]:.3g} beyond {ATTN_REL_TOL}")
        if control and control[name] <= ATTN_REL_TOL:
            raise AssertionError(f"train_attention {name} {tag}: a wrong seed moves the plain "
                                 f"version by only {control[name]:.3g}, within {ATTN_REL_TOL}")
    if not torch.equal(kernel(q, k, v), got[0]):
        raise AssertionError(f"train_attention {tag}: a second forward with the same seed "
                             "differs")
    return dict(abs_err=abs_err, rel=rel, control=control)


def check_train_attention(dev, g) -> dict:
    """The training attention's three kernels against the plain version and
    its autograd, forward output and q / k / v gradients, dropout on and off:
    b = 2 with a masked sample at n = 256, 1024 and 4096, then the train
    phase's own shape (9 x 4096, no mask); times at b = 2."""
    import torch
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    rel_max, control_min = {}, {}
    times = {}
    b_path, n_path = TRAIN_BATCH
    for b, n in ((2, 256), (2, 1024), (2, 4096), (b_path, n_path)):
        q, k, v, dout = (torch.randn((b, n, 16, 64), generator=g, device=dev).bfloat16()
                         for _ in range(4))
        lens = (torch.tensor([n, n - 37], dtype=torch.int32, device=dev) if b == 2 else None)
        seed = 0x5EED0000 + n + b
        for rate in (0.1, 0.0):
            res = check_train_attention_case(q, k, v, dout, lens, rate, seed)
            err = res["abs_err"]
            for name, e in (("fwd", err["fwd"]), ("dq", err["dq"]),
                            ("dkv", max(err["dk"], err["dv"]))):
                errs[name] = max(errs[name], e)
            for name, r in res["rel"].items():
                rel_max[name] = max(rel_max.get(name, 0.0), r)
            for name, c in res["control"].items():
                control_min[name] = min(control_min.get(name, math.inf), c)
        if b != 2:
            continue
        rate = 0.1
        out, lse = ta.flash_forward(q, k, v, lens, rate, seed)
        dd = ta.row_dot(dout, out)
        ms = {"fwd": cuda_median_ms(lambda: ta.flash_forward(q, k, v, lens, rate, seed)),
              "dq": cuda_median_ms(lambda: ta.flash_dq(q, k, v, lens, lse, dd, dout, rate, seed)),
              "dkv": cuda_median_ms(
                  lambda: ta.flash_dkv(q, k, v, lens, lse, dd, dout, rate, seed))}
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        plain_fwd = cuda_median_ms(lambda: ta.train_attention_reference(*args, lens, rate, seed),
                                   iters=5, warmup=1)
        ref = ta.train_attention_reference(*args, lens, rate, seed)
        plain_bwd = cuda_median_ms(lambda: torch.autograd.grad(ref, args, dout, retain_graph=True),
                                   iters=5, warmup=1)
        del ref
        # the yardstick: the library's attention, forward and backward, at
        # keep = 1 and without a mask (it has neither this dropout nor lens)
        lib_args = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        lib_fwd = cuda_median_ms(lambda: F.scaled_dot_product_attention(*lib_args))
        lib_out = F.scaled_dot_product_attention(*lib_args)
        lib_dout = dout.transpose(1, 2)
        lib_bwd = cuda_median_ms(
            lambda: torch.autograd.grad(lib_out, lib_args, lib_dout, retain_graph=True))
        del lib_out
        # q, k, v, dO, O / dq / dk, dv in bf16, the fp32 LSE and D rows; QK^T
        # (and dO V^T in the backward) and each product onto an output, over
        # each sample's valid keys
        elems, rows, keys = 2 * n * 16 * 64, 2 * 16 * n, n + n - 37
        work = 2.0 * 16 * 64 * n * keys
        least = {"fwd": bound(4 * elems * 2 + rows * 4 + 8, 2 * work),
                 "dq": bound(5 * elems * 2 + 2 * rows * 4 + 8, 3 * work),
                 "dkv": bound(6 * elems * 2 + 2 * rows * 4 + 8, 4 * work)}
        times[n] = {"fwd": dict(ms=ms["fwd"], plain_ms=plain_fwd, library_ms=lib_fwd,
                                **least["fwd"]),
                    "dq": dict(ms=ms["dq"], plain_ms=plain_bwd, library_ms=lib_bwd,
                               **least["dq"]),
                    "dkv": dict(ms=ms["dkv"], plain_ms=plain_bwd, library_ms=lib_bwd,
                                **least["dkv"])}
        log(f"[kernels] train_attention b=2 n={n} dropout {rate}: forward {ms['fwd']:.4f} ms "
            f"(plain {plain_fwd:.4f} ms), dq {ms['dq']:.4f} ms + dk/dv {ms['dkv']:.4f} ms "
            f"(plain backward, all three gradients, {plain_bwd:.4f} ms); bounds "
            + ", ".join(f"{name} {v['bound_ms']:.5f} ms by {v['bound_by']}"
                        for name, v in least.items())
            + f"; library scaled_dot_product_attention at keep = 1, no mask: forward "
            f"{lib_fwd:.4f} ms, backward (all three gradients) {lib_bwd:.4f} ms")
    log("[kernels] train_attention over every case: largest relative L2 error "
        + ", ".join(f"{name} {r:.3g}" for name, r in rel_max.items())
        + "; smallest control " + ", ".join(f"{name} {c:.3g}" for name, c in control_min.items())
        + f"; tol {ATTN_REL_TOL} between them")
    log("[kernels] the JSON line's training ms / plain_ms / bound_ms / library_ms are the "
        "b = 2, n = 4096 case's at dropout 0.1; plain_ms and library_ms of dq and dk/dv are "
        "the plain version's and the library's whole backward")
    return {f"train_attention_{name}": dict(max_abs_err=errs[name], **times[4096][name])
            for name in errs}


def randomize(modules, seed: int) -> None:
    """Every parameter of ``modules`` from N(0, WEIGHT_STD), one seeded
    generator on the parameters' device: the reference's zero-initialised
    AdaLN and output projections would make each block an identity. The
    gains of the UNetT's RMS norms (parameters named ``g``) get
    1 + N(0, WEIGHT_STD): a gain near 0 would silence every block."""
    import torch

    g = None
    with torch.no_grad():
        for module in modules:
            for name, p in module.named_parameters():
                if g is None:
                    g = torch.Generator(device=p.device).manual_seed(seed)
                p.normal_(0.0, WEIGHT_STD, generator=g)
                if name.split(".")[-1] == "g":
                    p.add_(1.0)


def build_wrapper(dev):
    import torch

    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    t0 = time.perf_counter()
    wrapper = F5TTSWrapper(model_name="F5TTS_v1_Base", vocab_char_map=vocab, device=dev,
                           compute_dtype="bfloat16", nfe_step=NFE)
    randomize((wrapper.transformer, wrapper.vocoder), SEED)
    torch.cuda.synchronize()
    a = wrapper.config.arch
    n_params = sum(p.numel() for p in wrapper.transformer.parameters())
    log(f"[main] F5TTS_v1_Base dim {a.dim} depth {a.depth} heads {a.heads}x{a.dim_head} "
        f"ff_mult {a.ff_mult} text_dim {a.text_dim} conv_layers {a.conv_layers}: "
        f"{n_params / 1e6:.1f} M DiT params, bf16, N(0, {WEIGHT_STD}) seed {SEED}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    return wrapper


def check_dit_against_plain(dit, dev, tag: str = "[main]", b: int = 2, n: int = 256):
    """One ``run`` of a backbone (DiT or UNetT) at full width with the kernels
    vs with the plain versions, on the same card and inputs: b rows of n
    frames, the second half of the rows with their conditioning dropped (as
    CFG doubles a batch), every odd row masked after n - 56 frames. Returns
    the largest error in units of the plain output's scale."""
    import torch

    from eraxvif5tts_tpu_torch.models import modules
    from eraxvif5tts_tpu_torch.ops.fused_matmul import ln_mod_matmul_reference
    from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
    from eraxvif5tts_tpu_torch.ops.quant_ff import int8_ff_reference
    from eraxvif5tts_tpu_torch.ops.serving_attention import serving_attention_reference

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((b, n, 100), generator=g, device=dev)
    cond = torch.randn((b, n, 100), generator=g, device=dev)
    text = torch.randint(0, 90, (b, 120), generator=g, device=dev)
    drop = torch.arange(b, device=dev) >= b // 2
    mask = lens_to_mask(n - 56 * (torch.arange(b, device=dev) % 2), n)
    time_ = torch.full((b,), 0.3, device=dev)

    def run():
        with torch.inference_mode():
            te = dit.embed_text(text, n, drop)
            return dit.run(x, cond, te, time_, drop, mask)

    got = run()
    saved = modules.dot_product_attention, modules.ln_mod_matmul, modules.int8_ff
    modules.dot_product_attention = lambda q, k, v, key_valid=None, rope=None: (
        serving_attention_reference(q, k, v, key_valid.sum(-1), rope))
    modules.ln_mod_matmul = ln_mod_matmul_reference
    modules.int8_ff = int8_ff_reference
    try:
        want = run()
    finally:
        modules.dot_product_attention, modules.ln_mod_matmul, modules.int8_ff = saved
    rel = float((got - want).abs().max() / want.abs().max())
    name = type(dit).__name__
    log(f"{tag} {name}.run b={b} n={n} kernels vs plain versions: max error {rel:.3g} of "
        f"scale {float(want.abs().max()):.3g} (tol {DIT_TOL})")
    if not torch.isfinite(got).all() or rel > DIT_TOL:
        raise AssertionError(f"{name} with kernels differs from plain by {rel:.3g}")
    return rel


def serving_counts() -> dict:
    """The serving kernels' launch counts by mode: attention with fused rotary
    and without, the normalised projection in layernorm and in RMS mode."""
    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa

    return {"serving_attention": sa.serving_attention.launches_by_rope[True],
            "serving_attention_norope": sa.serving_attention.launches_by_rope[False],
            "ln_mod_matmul": fm.ln_mod_matmul.launches_by_norm["ln"],
            "ln_mod_matmul_rms": fm.ln_mod_matmul.launches_by_norm["rms"]}


def reset_serving_counts() -> None:
    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa

    sa.serving_attention.launches = fm.ln_mod_matmul.launches = 0
    sa.serving_attention.launches_by_rope = {True: 0, False: 0}
    fm.ln_mod_matmul.launches_by_norm = {"ln": 0, "rms": 0}


def generate_counted(wrapper, ref, texts, nfe: int, tag: str, path: tuple[str, str]) -> dict:
    """Set the serving counters to 0, `generate` each text and read them:
    per request, the two kernels of ``path`` (names of :func:`serving_counts`)
    must each have launched depth x nfe x chunks times and the other two modes
    not at all. Logs the realtime factor per request; returns the counts."""
    import numpy as np

    buckets = []
    sample_vocode = wrapper._sample_vocode

    def counted(*args, **kwargs):
        buckets.append(kwargs["max_duration"])
        return sample_vocode(*args, **kwargs)

    wrapper._sample_vocode = counted
    depth = wrapper.config.arch.depth
    reset_serving_counts()
    total_audio = total_wall = 0.0
    try:
        for i, text in enumerate(texts):
            n_before, before = len(buckets), serving_counts()
            t0 = time.perf_counter()
            wave = wrapper.generate(text, seed=SEED + i, nfe_step=nfe)
            wall = time.perf_counter() - t0
            chunks = len(buckets) - n_before
            audio = len(wave) / wrapper.target_sample_rate
            total_audio, total_wall = total_audio + audio, total_wall + wall
            rose = {name: count - before[name] for name, count in serving_counts().items()}
            log(f"{tag} generate #{i}: {chunks} chunk(s) at buckets {buckets[n_before:]}, "
                f"{audio:.2f} s of audio in {wall:.3f} s (RTF {wall / audio:.4f}, "
                f"{audio / wall:.2f}x realtime); launches {rose}")
            if not (np.isfinite(wave).all() and np.abs(wave).max() > 1e-3 and len(wave) > 0):
                raise AssertionError(f"{tag} generate #{i}: PCM is not finite and non-silent")
            want = {name: depth * nfe * chunks if name in path else 0 for name in rose}
            if rose != want:
                raise AssertionError(f"{tag} generate #{i}: launches {rose}, expected {want} "
                                     f"({depth} x {nfe} x {chunks} on {path})")
    finally:
        wrapper._sample_vocode = sample_vocode
    log(f"{tag} {len(texts)} request(s): {total_audio:.2f} s of audio in {total_wall:.3f} s: "
        f"RTF {total_wall / total_audio:.4f} ({total_audio / total_wall:.2f}x realtime) at "
        f"NFE {nfe}, bf16, batch 1")
    return serving_counts()


KERNEL_GROUPS = (  # device kernels by name, first match
    ("kernel 1 (attention)", ("serving_attention_kernel",)),
    ("kernel 2 (norm + FF in)", ("ln_mod_matmul_kernel", "row_stats_kernel")),
    ("GEMMs", ("gemm", "nvjet", "cutlass", "cublas", "gemv")),
    ("convolutions", ("conv", "cudnn", "fft")),
)


def profile_generate(wrapper, ref, text: str, nfe: int, tag: str) -> None:
    """Where one warm `generate` spends its time: the wall of an unprofiled
    call, then the device kernels of a call under `torch.profiler`, summed by
    group, and the device's busy share of the unprofiled wall (below 100 % the
    host's eager dispatch, not the device, bounds the Euler loop)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wrapper.generate(text, seed=SEED, nfe_step=nfe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrapper.generate(text, seed=SEED, nfe_step=nfe)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wrapper.generate(text, seed=SEED, nfe_step=nfe)
        torch.cuda.synchronize()
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS} | {"elementwise, reductions, other": 0.0}
    launches = 0
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = event.key.lower()
        if "memcpy" in key or "memset" in key:
            continue
        group = next((name for name, marks in KERNEL_GROUPS if any(m in key for m in marks)),
                     "elementwise, reductions, other")
        groups[group] += event.self_device_time_total / 1e3
        launches += event.count
    device_ms = sum(groups.values())
    if device_ms <= 0.0:
        log(f"{tag} profile: the profiler recorded no device time; device share not measured")
        return
    log(f"{tag} profile of one warm generate at NFE {nfe}: wall {wall_ms:.1f} ms unprofiled; "
        f"{launches} device kernels, {device_ms:.1f} ms of device time = "
        f"{100 * device_ms / wall_ms:.1f} % of the wall (the rest: host dispatch with the "
        "device idle); "
        + ", ".join(f"{name} {ms:.1f} ms ({100 * ms / device_ms:.0f} %)"
                    for name, ms in groups.items()))


def check_f5tts_base(dev) -> None:
    """F5TTS_Base's options on the card, cut to BASE_DEPTH blocks and
    BASE_NFE steps (its full depth is F5TTS_v1_Base's 22; the options, not the
    depth, are what this adds): rotary on head 0 only, so the attention kernel
    runs without fused rotary on a DiT, and text padding left unmasked."""
    import torch

    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    cfg = PRESETS["F5TTS_Base"]
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, depth=BASE_DEPTH))
    wrapper = F5TTSWrapper(model_cfg=cfg, vocab_char_map={c: i for i, c in enumerate(VOCAB_CHARS)},
                           device=dev, compute_dtype="bfloat16", nfe_step=BASE_NFE)
    randomize((wrapper.transformer, wrapper.vocoder), SEED)
    torch.cuda.synchronize()
    a = wrapper.config.arch
    log(f"[main] F5TTS_Base options, CUT to depth {a.depth} of 22 and NFE {BASE_NFE}: dim "
        f"{a.dim}, heads {a.heads}x{a.dim_head}, pe_attn_head {a.pe_attn_head}, "
        f"text_mask_padding {a.text_mask_padding}")
    check_dit_against_plain(wrapper.transformer, dev, "[main] F5TTS_Base:")
    ref = load_reference(wrapper)
    wrapper.warmup(ref, nfe_step=2)
    generate_counted(wrapper, ref, TEXTS[:1], BASE_NFE, "[main] F5TTS_Base:",
                     ("serving_attention_norope", "ln_mod_matmul"))


def phase_main(dev) -> tuple[object, object, dict]:
    wrapper = build_wrapper(dev)
    check_dit_against_plain(wrapper.transformer, dev)

    ref = load_reference(wrapper)
    log(f"[main] reference: {ref.n_frames} frames ({ref.audio_seconds:.2f} s), "
        f"text {ref.text!r}")
    t0 = time.perf_counter()
    wrapper.warmup(ref)
    log(f"[main] warmup (one NFE-{NFE} step at the smallest bucket) "
        f"{time.perf_counter() - t0:.2f} s")
    counts = generate_counted(wrapper, ref, TEXTS, NFE, "[main]",
                              ("serving_attention", "ln_mod_matmul"))
    launches = {name: counts[name] for name in ("serving_attention", "ln_mod_matmul")}
    profile_generate(wrapper, ref, TEXTS[1], NFE, "[main]")
    check_f5tts_base(dev)
    return wrapper, ref, launches


def phase_server(wrapper, ref, texts=TEXTS, tag: str = "[server]"):
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
        for i, text in enumerate(texts):
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
            log(f"{tag} request #{i}: {len(pcm) / 24000:.2f} s of float32 audio + END, "
                f"first bytes after {first:.3f} s, done in {time.perf_counter() - t0:.3f} s")
    finally:
        stop.set()
        server.join(timeout=120)
    if server.is_alive():
        raise AssertionError("socket server did not shut down")
    log(f"{tag} socket server shut down")


def load_reference(wrapper):
    """The bundled reference clip and its transcript, preprocessed."""
    example = ROOT / "eraxvif5tts_tpu" / "infer" / "examples" / "basic"
    ref_text = tomllib.loads((example / "basic.toml").read_text())["ref_text"]
    return wrapper.preprocess_reference(str(example / "basic_ref_en.wav"), ref_text)


def save_reference_checkpoint(path: Path, cfg, dev) -> None:
    """A reference-format F5-TTS / E2-TTS checkpoint (EMA keys, fp32) of the
    backbone of ``cfg`` with every parameter drawn by :func:`randomize`, seed
    SEED + 3. The int8 wrapper must quantize real weights at load: its int8
    buffers cannot be redrawn after the build, and a fresh initialisation is
    degenerate for int8 (its zero AdaLN gates zero every quantized product)."""
    import torch

    from eraxvif5tts_tpu_torch.models import build_backbone

    backbone = build_backbone(cfg, len(VOCAB_CHARS)).to(dev)
    randomize((backbone,), SEED + 3)
    torch.save({f"ema_model.transformer.{k}": v.cpu()
                for k, v in backbone.state_dict().items()}, path)


def run_batch(wrapper, depth: int, nfe: int, seed: int, int8_ff: bool, label: str):
    """One `generate_batch` of BATCH_TEXTS, ERAX_INT8_FF set or unset, with
    its launch counters checked: kernel 1 depth x NFE, kernel 5 as many with
    the one-kernel feed-forward and none without, kernel 2 none on the int8
    path (quantized blocks take the unfused FF). Returns (waves, wall s,
    seconds of audio)."""
    import numpy as np
    import torch

    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.ops import quant_ff as qf
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa

    quantized = wrapper.compute_dtype == "int8"
    if int8_ff:
        os.environ["ERAX_INT8_FF"] = "1"
    else:
        os.environ.pop("ERAX_INT8_FF", None)
    counters = (sa.serving_attention, qf.int8_ff, fm.ln_mod_matmul)
    before = [fn.launches for fn in counters]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        waves = wrapper.generate_batch(list(BATCH_TEXTS), nfe_step=nfe, seed=seed)
    finally:
        os.environ.pop("ERAX_INT8_FF", None)
    wall = time.perf_counter() - t0
    counts = [fn.launches - c for fn, c in zip(counters, before)]
    audio = sum(len(w) for w in waves) / wrapper.target_sample_rate
    want = [depth * nfe, depth * nfe if int8_ff else 0, 0 if quantized else depth * nfe]
    log(f"[int8] generate_batch {label} ({len(waves)} texts, NFE {nfe}): {audio:.2f} s of "
        f"audio in {wall:.3f} s ({audio / wall:.2f} s of audio per wall s); launches "
        f"attention / int8_ff / ln_mod {counts}")
    if counts != want:
        raise AssertionError(f"generate_batch {label}: launches {counts}, expected {want}")
    if len(waves) != len(BATCH_TEXTS) or not all(
            len(w) > 0 and np.isfinite(w).all() and np.abs(w).max() > 1e-3 for w in waves):
        raise AssertionError(f"generate_batch {label}: PCM is not finite and non-silent")
    return waves, wall, audio


def phase_int8(dev, cfg) -> tuple[dict, float]:
    """Returns the int8 feed-forward's launches in the measured batch calls
    and its error against the plain version at the batch's own shape."""
    import numpy as np
    import torch

    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.models import modules
    from eraxvif5tts_tpu_torch.ops import quant_ff as qf
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa

    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    depth = cfg.arch.depth
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "model.pt"
        t0 = time.perf_counter()
        save_reference_checkpoint(ckpt, cfg, dev)
        log(f"[int8] reference-format checkpoint of N(0, {WEIGHT_STD}) weights, seed "
            f"{SEED + 3}: {ckpt.stat().st_size / 2**30:.2f} GiB written in "
            f"{time.perf_counter() - t0:.1f} s")
        common = dict(model_cfg=cfg, ckpt_path=str(ckpt), vocab_char_map=vocab, device=dev,
                      nfe_step=NFE)
        t0 = time.perf_counter()
        int8 = F5TTSWrapper(compute_dtype="int8", int8_validate=True, **common)
        torch.cuda.synchronize()
        report = int8.int8_report
        log(f"[int8] F5TTSWrapper(compute_dtype='int8', int8_validate=True) built in "
            f"{time.perf_counter() - t0:.1f} s; quality gate (8 steps, max_duration 256, "
            f"against a bf16 twin): rel_mse {report['rel_mse']:.4g}, lsd_db "
            f"{report['lsd_db']:.4g}, forward_rel_mse {report['forward_rel_mse']:.4g}, "
            f"passes {report['passes_gate']}")
        bf16 = F5TTSWrapper(compute_dtype="bfloat16", **common)
    # the vocoders: the same seeded draw as the main phase's
    randomize((int8.vocoder,), SEED)
    randomize((bf16.vocoder,), SEED)
    blocks = int8.transformer.transformer_blocks
    q_bytes = sum(b.numel() for name, b in int8.transformer.named_buffers()
                  if name.endswith("weight_q"))
    log(f"[int8] {len(blocks)} quantized blocks: {q_bytes / 2**20:.1f} MiB of int8 weights "
        f"(6 projections a block), the rest bf16 matrices and fp32 vectors")
    load_reference(int8)
    load_reference(bf16)
    runs = {"bf16": (bf16, False), "int8 chain": (int8, False), "int8 fused": (int8, True)}
    shapes = set()  # the [rows, frames] the batch gives kernel 5 (with CFG)
    ff = modules.int8_ff

    def recorded(x, *args, **kwargs):
        shapes.add(tuple(x.shape[:2]))
        return ff(x, *args, **kwargs)

    modules.int8_ff = recorded
    try:
        for label, (wrapper, int8_ff) in runs.items():  # warm-up: first calls at this bucket
            run_batch(wrapper, depth, 2, SEED, int8_ff, f"{label} warm-up")
    finally:
        modules.int8_ff = ff
    (b, n), = shapes
    log(f"[int8] the batch of {len(BATCH_TEXTS)} texts runs the DiT at {b} rows x {n} frames")
    for int8_ff in (False, True):
        if int8_ff:
            os.environ["ERAX_INT8_FF"] = "1"
        try:
            check_dit_against_plain(int8.transformer, dev,
                                    f"[int8] ERAX_INT8_FF={'1' if int8_ff else 'unset'}:", b, n)
        finally:
            os.environ.pop("ERAX_INT8_FF", None)
    ff_err = check_int8_ff_shape(dev, torch.Generator(device=dev).manual_seed(SEED + 5), b, n,
                                 "[int8]")[0]
    sa.serving_attention.launches = qf.int8_ff.launches = 0
    waves, walls, audio = {}, {label: [] for label in runs}, {}
    for label in (*runs, *reversed(runs)):
        wrapper, int8_ff = runs[label]
        waves[label], wall, audio[label] = run_batch(wrapper, depth, NFE, SEED + 4, int8_ff,
                                                     label)
        walls[label].append(wall)
    launches = {"int8_ff": qf.int8_ff.launches}
    diffs = [float(np.abs(a - b).max()) for a, b in zip(waves["int8 chain"], waves["int8 fused"])]
    rel = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
           for a, b in zip(waves["int8 chain"], waves["int8 fused"])]
    log(f"[int8] int8 chain vs fused, same seed, per text: max |difference| "
        f"{max(diffs):.4g} of full scale, relative L2 {min(rel):.3g}-{max(rel):.3g} (the fused "
        f"feed-forward keeps the hidden state in fp32; the chain rounds it to bf16)")
    rates = {label: audio[label] / statistics.mean(w) for label, w in walls.items()}
    log("[int8] throughput, seconds of audio per wall second (mean of two calls in turns "
        f"bf16, chain, fused, fused, chain, bf16; batch {len(BATCH_TEXTS)}, NFE {NFE}): "
        + ", ".join(f"{label} {rate:.3f}" for label, rate in rates.items())
        + f"; int8 chain / bf16 {rates['int8 chain'] / rates['bf16']:.3f}, int8 fused / bf16 "
        f"{rates['int8 fused'] / rates['bf16']:.3f}")
    return launches, ff_err


def train_arch():
    """F5TTS_v1_Base's architecture (the reference `configs/F5TTS_v1_Base.yaml`
    model.arch) with the training settings of the train phase."""
    from eraxvif5tts_tpu_torch.models.dit import ArchConfig

    # remat "full": what the JAX package's resolve_remat_policy("auto", frames)
    # picks at the 38,400-frame single-chip budget, above its 6 x 4096-frame
    # "dots" threshold (eraxvif5tts_tpu/configs/__init__.py:139-161)
    return ArchConfig(dim=1024, depth=22, heads=16, dim_head=64, ff_mult=2, text_dim=512,
                      conv_layers=4, dropout=0.1, checkpoint_activations=True,
                      remat_policy="full")


def check_loss_against_plain(cfm, dev):
    """One CFM.loss forward and backward at b = 2, n = 1024 with the training
    kernels against the same model with the plain attention, on the same
    draws and dropout keys: the loss, the whole flattened gradient and the
    gradient of the q / k / v projections (which reaches the parameters only
    through the attention backward). The control is the plain attention with
    the attention-dropout keys of every block changed; it must move each
    reading beyond its limit, or that limit could not see wrong masks."""
    import torch

    from eraxvif5tts_tpu_torch.models.cfm import LossDraws
    from eraxvif5tts_tpu_torch.ops.train_attention import train_attention

    dit = cfm.transformer
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    b, n = 2, 1024
    mel = torch.randn((b, n, 100), generator=g, device=dev)
    lens = torch.tensor([n, n - 37], device=dev)
    text = torch.randint(0, len(VOCAB_CHARS), (b, TRAIN_TEXT), generator=g, device=dev)
    text[1, 300:] = -1
    draws = LossDraws.sample(g, b, n, 100, len(dit.transformer_blocks))
    wrong = dataclasses.replace(draws, dropout_keys=[
        [[(attn[0] + 1) & 0xFFFFFFFF, attn[1]], out, ff]
        for attn, out, ff in draws.dropout_keys])
    qkv = [p for name, p in dit.named_parameters()
           if name.split(".")[-2] in ("to_q", "to_k", "to_v")]

    def loss_and_grads(draws, plain):
        dit.zero_grad(set_to_none=True)
        train_attention.plain = plain
        try:
            loss = cfm.loss(mel, text, lens, draws)[0]
            loss.backward()
        finally:
            train_attention.plain = False
        return (loss.item(), torch.cat([p.grad.flatten() for p in dit.parameters()]),
                torch.cat([p.grad.flatten() for p in qkv]))

    got = loss_and_grads(draws, plain=False)
    want = loss_and_grads(draws, plain=True)
    control = loss_and_grads(wrong, plain=True)
    dit.zero_grad(set_to_none=True)

    def distance(x):
        return (abs(x[0] - want[0]) / abs(want[0]), rel_l2(x[1], want[1]),
                rel_l2(x[2], want[2]))

    err, ctl = distance(got), distance(control)
    tols = (LOSS_TOL, GRAD_TOL, QKV_GRAD_TOL)
    log(f"[train] CFM.loss b={b} n={n} dropout {dit.arch.dropout}, kernels vs plain attention: "
        f"loss {got[0]:.6f} vs {want[0]:.6f}; relative errors (tol) / control (plain, wrong "
        "attention-dropout keys): "
        + ", ".join(f"{name} {e:.3g} ({t}) / {c:.3g}" for name, e, t, c in
                    zip(("loss", "gradient L2", "q/k/v gradient L2"), err, tols, ctl)))
    if not (all(e <= t for e, t in zip(err, tols)) and torch.isfinite(got[1]).all()):
        raise AssertionError(f"CFM.loss with kernels differs from plain: {err}")
    if not all(c > t for c, t in zip(ctl, tols)):
        raise AssertionError(f"wrong attention-dropout keys move the plain readings by only "
                             f"{ctl}, not beyond the limits {tols}")


def phase_train(dev, arch=None) -> dict:
    import torch

    from eraxvif5tts_tpu_torch.models.cfm import CFM
    from eraxvif5tts_tpu_torch.models.dit import DiT
    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.training.trainer import (
        Trainer,
        batch_seed,
        checkpoint_restore,
        checkpoint_save,
        make_optimizer,
    )

    t0 = time.perf_counter()
    arch = arch or train_arch()
    dit = DiT(arch, text_num_embeds=len(VOCAB_CHARS), mel_dim=100,
              compute_dtype=torch.bfloat16).to(dev)
    randomize((dit,), SEED)
    cfm = CFM(dit.train())
    n_params = sum(p.numel() for p in dit.parameters())
    log(f"[train] F5TTS_v1_Base dim {arch.dim} depth {arch.depth} heads {arch.heads}x"
        f"{arch.dim_head}: {n_params / 1e6:.1f} M fp32 parameters, bf16 compute, dropout "
        f"{arch.dropout}, remat {arch.remat_policy} (frame budget {TRAIN_FRAME_BUDGET}), "
        f"N(0, {WEIGHT_STD}) seed {SEED}, built in {time.perf_counter() - t0:.1f} s")
    check_loss_against_plain(cfm, dev)

    # warmup cut from 20,000 to 1 update so that the smoke's updates move the weights
    trainer = Trainer(cfm=cfm, optimizer=make_optimizer(num_warmup_updates=1,
                                                         total_updates=1000))
    state = trainer.init_state()
    params0 = [p.detach().clone() for p in dit.parameters()]
    b, n = TRAIN_BATCH
    depth = arch.depth
    kernels = (ta.flash_forward, ta.flash_dq, ta.flash_dkv)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for i, rate in enumerate((0.1, 0.1, 0.1, 0.0)):
        dit.arch = dataclasses.replace(dit.arch, dropout=rate)
        bg = torch.Generator(device=dev).manual_seed(SEED + 10 + i)
        lens = torch.randint(n // 2, n + 1, (b,), generator=bg, device=dev)
        text = torch.randint(0, len(VOCAB_CHARS), (b, TRAIN_TEXT), generator=bg, device=dev)
        text_lens = torch.randint(TRAIN_TEXT // 4, TRAIN_TEXT + 1, (b, 1), generator=bg,
                                  device=dev)
        text = text.masked_fill(torch.arange(TRAIN_TEXT, device=dev) >= text_lens, -1)
        batch = {"mel": torch.randn((b, n, 100), generator=bg, device=dev), "text": text,
                 "lens": lens}
        before = [fn.launches for fn in kernels]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(
            state, batch, torch.Generator(device=dev).manual_seed(batch_seed(SEED, 0, i)))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = [fn.launches - c for fn, c in zip(kernels, before)]
        log(f"[train] step {i + 1} b={b} n={n} dropout {rate}: loss {metrics['loss']:.5f}, "
            f"grad_norm {metrics['grad_norm']:.5f}, applied {metrics['applied']:.0f}, "
            f"{walls[-1]:.3f} s; launches fwd/dq/dkv {counts}")
        if not (math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])
                and metrics["applied"] == 1.0):
            raise AssertionError(f"step {i + 1}: non-finite loss / grad norm or not applied")
        if counts != [2 * depth, depth, depth]:
            raise AssertionError(f"step {i + 1}: launches {counts}, expected "
                                 f"[{2 * depth}, {depth}, {depth}] (forward twice: checkpointed)")
    launches = {f"train_attention_{name}": fn.launches
                for name, fn in zip(("fwd", "dq", "dkv"), kernels)}
    peak = torch.cuda.max_memory_allocated(dev)
    step_s = statistics.median(walls[1:])
    log(f"[train] steps 2-4 median {step_s:.3f} s per step: {b * n / step_s:.0f} frames/s "
        f"({b} x {n} padded frames), peak memory {peak / 2**30:.2f} GiB")
    if state.step != 4:
        raise AssertionError(f"{state.step} updates applied, expected 4")
    moved = sum(not torch.equal(p, p0) for p, p0 in zip(dit.parameters(), params0))
    ema_moved = sum(not torch.equal(e, p0) for e, p0 in zip(state.ema_params.values(), params0))
    log(f"[train] parameter tensors changed {moved}/{len(params0)}, EMA {ema_moved}/{len(params0)}")
    if moved != len(params0) or ema_moved != len(params0):
        raise AssertionError("training did not move every parameter tensor and its EMA")
    del params0

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = checkpoint_save(tmp, state, state.step)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        saved = [p.detach().clone() for p in dit.parameters()]
        saved_ema = [e.clone() for e in state.ema_params.values()]
        with torch.no_grad():
            for t in [*dit.parameters(), *state.ema_params.values()]:
                t.zero_()
        t0 = time.perf_counter()
        checkpoint_restore(path, state)
        restore_s = time.perf_counter() - t0
    same = (all(torch.equal(p, s) for p, s in zip(dit.parameters(), saved))
            and all(torch.equal(e, s) for e, s in zip(state.ema_params.values(), saved_ema)))
    log(f"[train] checkpoint model_{state.step}: {size / 2**30:.2f} GiB saved in {save_s:.2f} s, "
        f"restored in {restore_s:.2f} s; parameters and EMA identical: {same}")
    if not same:
        raise AssertionError("checkpoint restore did not give back the saved parameters")
    return launches


def phase_e2tts(dev, cfg=None) -> dict:
    """E2-TTS zero-shot cloning at full E2TTS_Base width and depth (``cfg``:
    another UNetT configuration, for a rehearsal). Returns the launches of
    the attention kernel without fused rotary and of the projection kernel in
    RMS mode over the three requests."""
    import torch

    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.models.unett import UNetT

    cfg = cfg or PRESETS["E2TTS_Base"]
    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "model.pt"
        t0 = time.perf_counter()
        save_reference_checkpoint(ckpt, cfg, dev)
        log(f"[e2tts] reference-format checkpoint of N(0, {WEIGHT_STD}) weights (norm gains "
            f"1 + N(0, {WEIGHT_STD})), seed {SEED + 3}: {ckpt.stat().st_size / 2**30:.2f} GiB "
            f"written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        wrapper = F5TTSWrapper(model_cfg=cfg, ckpt_path=str(ckpt), vocab_char_map=vocab,
                               device=dev, compute_dtype="bfloat16", nfe_step=NFE)
        torch.cuda.synchronize()
    unett = wrapper.transformer
    if not isinstance(unett, UNetT):
        raise AssertionError(f"the e2tts phase built a {type(unett).__name__}, not a UNetT")
    randomize((wrapper.vocoder,), SEED)  # the same seeded draw as the main phase's
    a = wrapper.config.arch
    n_params = sum(p.numel() for p in unett.parameters())
    log(f"[e2tts] {cfg.name} UNetT dim {a.dim} depth {a.depth} heads {a.heads}x{a.dim_head} "
        f"ff_mult {a.ff_mult} pe_attn_head {a.pe_attn_head} conv_layers {a.conv_layers}: "
        f"{n_params / 1e6:.1f} M params, bf16, loaded strict from the checkpoint in "
        f"{time.perf_counter() - t0:.1f} s; mel buckets {wrapper.duration_buckets[:3]}... "
        "(64k - 1: the time token is frame 0)")
    # 255 mel frames: 256 positions with the time token
    check_dit_against_plain(unett, dev, "[e2tts]", 2, 255)

    ref = load_reference(wrapper)
    t0 = time.perf_counter()
    wrapper.warmup(ref)
    log(f"[e2tts] reference {ref.n_frames} frames; warmup (one NFE-{NFE} step at the smallest "
        f"bucket) {time.perf_counter() - t0:.2f} s")
    path = ("serving_attention_norope", "ln_mod_matmul_rms")
    counts = generate_counted(wrapper, ref, TEXTS, NFE, "[e2tts]", path)
    profile_generate(wrapper, ref, TEXTS[1], NFE, "[e2tts]")
    phase_server(wrapper, ref, TEXTS[:1], "[e2tts]")
    return {name: counts[name] for name in path}


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
    cfg = wrapper.config
    del wrapper, ref
    int8_launches, ff_err = phase_int8(dev, cfg)
    launches.update(int8_launches)
    kernel_results["int8_ff"]["max_abs_err"] = max(kernel_results["int8_ff"]["max_abs_err"],
                                                   ff_err)
    launches.update(phase_train(dev))
    launches.update(phase_e2tts(dev))
    kernels = [
        *(dict(name=name, route="cuda",
               source="eraxvif5tts_tpu_torch/csrc/serving_attention.cu",
               replaces="eraxvif5tts_tpu/ops/serving_attention.py:121",
               launches=launches[name], **kernel_results[name])
          for name in ("serving_attention", "serving_attention_norope")),
        *(dict(name=name, route="cuda",
               source="eraxvif5tts_tpu_torch/csrc/ln_mod_matmul.cu",
               replaces="eraxvif5tts_tpu/ops/fused_matmul.py:68",
               launches=launches[name], **kernel_results[name])
          for name in ("ln_mod_matmul", "ln_mod_matmul_rms")),
        dict(name="int8_ff", route="cuda", source="eraxvif5tts_tpu_torch/csrc/int8_ff.cu",
             replaces="eraxvif5tts_tpu/ops/quant_ff.py:101", launches=launches["int8_ff"],
             **kernel_results["int8_ff"]),
        dict(name="matmul_gate_res", route="cuda",
             source="eraxvif5tts_tpu_torch/csrc/matmul_gate_res.cu",
             replaces="eraxvif5tts_tpu/ops/fused_matmul.py:99", **kernel_results["matmul_gate_res"]),
        *(dict(name=name, route="cuda",
               source="eraxvif5tts_tpu_torch/csrc/train_attention.cu",
               replaces=f"eraxvif5tts_tpu/ops/train_attention.py:{line}",
               launches=launches[name], **kernel_results[name])
          for name, line in (("train_attention_fwd", 104), ("train_attention_dq", 150),
                             ("train_attention_dkv", 190))),
    ]
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    wrong = [k["name"] for k in kernels if set(k) != keys]
    if wrong:
        raise AssertionError(f"kernel records without the full set of keys: {wrong}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
