#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device  -- require a CUDA device; print `nvidia-smi`'s name and power limit;
2. build   -- build the CUDA kernels from `eraxvif5tts_tpu_torch/csrc/` with
              nvcc and print the build time, ptxas' resource report and what
              one TMA tensor-map encode costs the host;
3. kernels -- each kernel against its plain PyTorch version on the card at the
              serving and training shapes, with its tolerance, median
              CUDA-event times, the least time the card could take for the
              same inputs (bytes and operations over the H100's published
              peaks) and, where one PyTorch call computes the same function,
              that call's time as a yardstick (the serving attention with and
              without fused rotary, also at n = 6144, the MMDiT's longest joint
              sequence (text bucket 2048 + mel bucket 4096, lengths 6144 and
              2048 + 1051), at n = 64 and 192 and with lengths
              that end inside a tile, on a tile's edge, at 0 and not given,
              each second call bit-identical; the normalised projection in its
              layernorm and RMS modes and the gated residual projection, which
              no model calls, masked and unmasked, at b = 2 and at the batch
              call's 16 x 768 rows, beside the unfused bf16 chain and
              `F.linear` alone as yardsticks, and at the uneven edges of the
              GEMM core's tiles (M = 1, 63, 64, 65, 129, 767, K = 768, lengths
              of 0, of M and inside a tile), each second call bit-identical;
              the training attention forward and both
              backward kernels against the plain version's autograd, also
              at n = 192 and 4032, which leave the backward's last 128-row
              block half empty, and at the train phase's 9 x 4096 shape, each
              limit checked against a wrong-seed control, the forward's LSE
              against the plain log sum exp, each second forward and backward
              bit-identical, timed at dropout 0.1 and at keep = 1, and in bf16
              and fp32 on the MMDiT's joint sequence, n = 4160, 5120 and 6144
              with lens [n, n - 37] and [0, n - 37] at dropout 0.1 and keep
              = 1 (fp32 with a TF32 control refused), timed beside
              `scaled_dot_product_attention` at keep = 1; the int8
              feed-forward at ff_mult 2 (K 1024, N 2048) and 4 (K 1024, N 4096;
              K 768, N 3072) at b = 2, M = 256 and 1088, at 16 x 768 and at
              R = 1, 63, 64, 65, 129, 767, its hidden codes equal to the plain
              version's bit for bit, each second call bit-identical, timed
              beside the QuantLinear chain and `torch._int_mm` alone);
4. main    -- `F5TTSWrapper` at F5TTS_v1_Base width (dim 1024, depth 22,
              16 x 64 heads) in bf16 from seeded random weights: the DiT with
              its kernels against the same DiT with the plain versions, then
              `preprocess_reference` of the bundled clip; the [dispatch]
              checks (a chunk is one CUDA graph replay, captured at its key's
              first call: at two keys of DISPATCH_NFE steps the first call and
              a replay each equal to the eager step bit for bit, a second
              reference of the same length with another mel and RMS under one
              key equal to its own eager step, a traced replay's kernels equal
              to the counters, no host cache grown by a capture, the graphs
              and the pool's bytes; the same in the fp32, int8, e2tts, mmdit
              and bigvgan phases); `generate` of three texts at NFE 32, with
              the launch counters checked per backbone step the card ran
              (NFE a chunk's replay, one the eager run before a capture) and the
              realtime factor printed; a `generate` of four chunks or more
              (three in flight before the first fetch, PCM equal bit for bit
              to the eager step's) and one more under `torch.profiler` (device
              time by kernel group, one `cudaGraphLaunch` a chunk, the
              device's busy share of the wall); then F5TTS_Base's options (rotary
              on head 0 only, unmasked text padding) on a DiT cut to 4 blocks:
              kernels against plain, one `generate` at NFE 8, counters checked;
5. server  -- the socket server on a free localhost port answers three
              requests and shuts down;
5b. http   -- benchmark cell 4 on the main phase's wrapper: the port's HTTP
              server (`serving/http_server.py`) on a free localhost port in a
              thread with its own event loop, the bundled clip uploaded as
              multipart, three streams at NFE 32 (by `reference_id`, by the
              `speaker` alias, seeded), then two seeded streams one after the
              other and at once: the chunked WAV header and int16 PCM, the
              seeded stream equal to `generate`'s PCM and the concurrent
              streams to the serial ones bit for bit, kernels 1 and 2
              launched 22 x 32 per chunk (summed over concurrent streams),
              time to the first PCM bytes and RTF per stream, `generate`'s
              wall on and off the main thread, no thread left after the
              shutdown;
5c. edit   -- `edit_speech` of the bundled clip with one span at NFE 32 (kept
              frames equal to the prompt mel, 22 x 32 launches of kernels 1
              and 2), then `python -m eraxvif5tts_tpu_torch.infer.infer_cli`
              with the bundled basic.toml and no --device as a subprocess, on
              a reference-format checkpoint of the main wrapper's weights:
              its WAV checked;
5d. bigvgan -- the main phase's weights as a reference-format checkpoint,
              served by `F5TTSWrapper("F5TTS_v1_Base", vocoder_name="bigvgan")`
              with the full `bigvgan_v2_24khz_100band_256x` generator (1536
              initial channels, random weights as the JAX wrapper draws them)
              in fp32 beside the bf16 DiT: three `generate`s at NFE 32 with
              kernels 1 (rotary) and 2 counted 22 x 32 per chunk, BigVGAN's
              share of one `generate`, the card's BigVGAN against the CPU's on
              a 128-frame generated mel (with a TF32 control), cuDNN's TF32
              flag the same after the phase as before;
5e. mmdit  -- F5TTS_v1_MMDiT at full width (dim 1024, 16 x 64 heads,
              ff_mult 2) and its depth cut to MMDIT_DEPTH = 7 of 22 blocks
              (since the mesh phase) in bf16 from a seeded
              N(0, 0.02) reference-format checkpoint loaded strict: the MMDiT
              with its kernels against the plain versions at b = 2, n = 256
              with text 128 and at the longest joint sequence (text 2048 + mel
              4096 = 6144, kernel 1's launches counted), then three `generate`s
              at NFE 32 with kernel 1 without rotary counted depth x 32 per
              chunk and kernel 2 at 0, and a profiled request;
5f. fp32   -- fp32 serving, the JAX wrapper's default dtype: kernel 1's fp32
              kernel against its plain version (TF32 off) with and without
              rotary at n = 1088 (lens 1051, 0) and n = 6144 (lens 6144,
              2048 + 1051), within 2e-5 * (1 + |plain|), a second call
              and a call with both TF32 flags on bit-identical, the plain
              version held to the CPU's at 1088 and a TF32 control refused,
              timed beside fp32 `scaled_dot_product_attention`, with its
              bound at the 3xTF32 rate and the FFMA rate's beside; the built
              geometry of both fp32 forwards against the stated one; the main
              phase's weights through a reference-format checkpoint served
              by `F5TTSWrapper("F5TTS_v1_Base")` with no `compute_dtype`
              (fp32, full width and depth): one backbone call against the
              CPU's (TF32 flags on outside the call, a control with TF32 on
              inside it), three `generate`s at NFE 32 with the fp32 kernel
              with rotary counted 22 x 32 a chunk and kernel 2 at 0, a
              profiled request, its RTF beside the main phase's; then the
              mmdit phase's checkpoint served in fp32, one request with the
              fp32 kernel without rotary counted depth x 32 a chunk;
5g. bench  -- `eraxvif5tts_tpu_torch/tools/bench.py`'s workload (the JAX
              `bench.py`'s: a random F5TTS_v1_Base, bucket 1024 with a
              256-frame prompt, NFE 32) in fp32 and bf16, its lines logged;
5h. mmdit-int8 -- the mmdit phase's checkpoint served by
              `F5TTSWrapper("F5TTS_v1_MMDiT", compute_dtype="int8",
              int8_validate=True)` behind the unchanged quality gate (its text
              padded to 64 tokens), the quantized MMDiT against its plain
              versions and kernel 5 at both streams' shapes (the mel bucket's
              rows and the text bucket's), then one `generate_batch` of eight
              texts at NFE 32 each in bf16, int8 chain and int8 fused, with
              kernel 1 counted depth x 32 and kernel 5 (2 depth - 1) x 32
              (`ff_x` in every block, `ff_c` in all but the last) in the
              fused call;
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
              checked per call and seconds of audio per wall second printed,
              and one more bf16 and one more int8 fused batch under
              `torch.profiler`;
7. train   -- CFM training of F5TTS_v1_Base at full width (fp32 parameters,
              bf16 compute, dropout 0.1, seeded random weights): one
              `CFM.loss` forward and backward with the kernels against the
              plain attention (and a wrong-mask control), then `Trainer.train_step` on the single-chip
              reference batch (9 x 4096 frames, blocks checkpointed) for three
              steps at dropout 0.1 and one at dropout 0, with the launch
              counters checked per step, a checkpoint save / restore, and one
              more step under `torch.profiler` (device time of the attention
              kernels, the hash dropout and the other groups);
7a. train-cli -- the training CLI's path at full F5TTS_v1_Base width:
              `configs/F5TTS_v1_Base.yaml` as the port loads it (bf16
              compute, no activation checkpointing, 38,400-frame batches of
              <= 64 samples, 16 mel workers; one epoch, the warmup cut to 1
              update, a save every 3), an in-memory `CustomDataset` of 140
              wav files of 3-20 s made from the bundled clip (the host mel
              FFT per sample, batches prefetched) with texts and
              character phonemes, a seeded duration predictor (vocab 97,
              512, 32, 3, 0.5): `build_sampler` -> `build_trainer` ->
              `_run_training` over the epoch's four batches, two
              duration-focus updates (backbone and EMA bit for bit, kernel
              4a only) then full ones (every tensor moved, 4a / 4b / 4c
              depth each), the `model_3` save with its sample (kernels 1 and
              2 depth x 16) and the predictor's files, `model_last`; each
              update's wall, frames/s, the host's wait for its batch and
              its MAS share, the checkpoint's size and save time, the peak
              memory; the predictor loaded back on the card; a resume from
              `model_3` whose update 4 loss equals the first run's; MAS
              window / progressive / viterbi on one real batch, card
              against CPU (rows sum to their mel length, >= 99 % of the
              tokens agree);
7b. train-fp32 -- CFM training in fp32, the JAX DiT's default compute dtype:
              kernels 4a / 4b / 4c fp32 (`csrc/train_attention_fp32.cu`:
              all three on the tensor cores in 3xTF32) against the
              plain version with TF32 off at b = 2, h = 16, n = 64 (a sample
              with no valid key), 1024 and 4096, dropout 0.1 and 0 (O within
              2e-5 * (1 + |plain|), the gradients within 5e-5 of their
              scale, the LSE, second calls bit-identical, and bit-identical
              with both TF32 flags on at n = 4096), a TF32 control refused
              and the plain version held to the CPU's, timed beside fp32
              `scaled_dot_product_attention` and its backward, with bounds
              at the 3xTF32 rate and the FFMA rate's beside;
              F5TTS_v1_Base at full width and depth with fp32 parameters and
              fp32 compute (dropout 0.1, blocks checkpointed): one
              `Trainer.train_step` at b = 2, n = 128 against the CPU's (loss
              and whole gradient; both TF32 flags on outside the step, a
              control without the trainer's fp32 block), then a warm-up and
              two timed steps at 9 x 4096 frames (dropout 0.1 and 0) with
              the fp32 kernels counted 44 / 22 / 22 a step and the bf16 ones
              at 0, a profiled step, four applied updates; one fp32
              `DistillTrainer` step at 2 x 4096 with this model as the
              teacher and a 14-block student pruned from its first
              weights by the pruner's scores;
7c. mmdit-train -- MMDiT training: F5TTS_v1_MMDiT at full width, 11 of 22
              blocks (MMDIT_TRAIN_DEPTH), at dropout 0 (0.1, the preset's, refused before any launch: the
              JAX MMDiT cannot train at it), fp32 parameters, no activation
              checkpointing, in bf16 compute and then in fp32: one step
              against plain attention at b = 2, 256 + 1024 (loss, whole and
              q / k / v gradients; fp32 with a TF32 control), then
              `Trainer.train_step` at the joint text 1024 + mel 4096 at the
              largest batch that fits (a warm-up and two timed steps in bf16,
              a warm-up and one in fp32) with kernel 4 of the step's dtype
              counted depth / depth / depth a step, the peak memory, a profiled step;
7d. d128   -- head dim 128 in kernels 1 and 4 (after train-fp32): the
              built geometry of every attention kernel at d = 64 and 128
              against the stated one and the C interface refusing d = 32;
              kernel 1 at d = 128 (b = 2, h = 8) in bf16 and fp32 at n =
              1088 (lens 1051, 0) with and without rotary and at the joint
              6144 without, kernels 4a-4c at n = 4096 and 6144 at dropout 0.1
              and keep = 1, each against its plain version beside planted
              faults (head columns 64-127 of V or K zeroed) that must be
              refused, timed beside its bound, its plain version and
              `scaled_dot_product_attention`; the keep bits of 4a and 4c bit
              for bit; `configs/F5TTS_v1_Base.yaml` with 8 heads of 128 (dim
              1024, 22 blocks) written to a temporary directory and loaded by
              the port's loader, a seeded N(0, 0.02) reference-format
              checkpoint served in bf16 (the DiT against its plain versions)
              and default-built fp32 (against the CPU): `generate` of two
              texts at NFE 32, 22 x 32 launches a chunk, all of the d = 128
              instantiation; one CFM training step at 2 x 4096 (dropout 0.1,
              blocks checkpointed) in bf16 and in fp32, loss and gradient
              against plain attention with a wrong-keys control, a warm-up
              and a timed `Trainer.train_step` each, with its wall and peak
              memory;
8. e2tts   -- E2-TTS serving at E2TTS_Base width (UNetT: dim 1024, 16 x 64
              heads, ff_mult 4, rotary on head 0 only), its depth cut to
              E2TTS_DEPTH = 8 of 24 layers (since the mesh phase), in
              bf16: a seeded N(0, 0.02) reference-format checkpoint (norm gains
              1 + N(0, 0.02)) loaded through the port's converter, the UNetT
              with its kernels against the plain versions, `generate` of the
              three texts at NFE 32 with the launch counters checked per chunk
              (the attention kernel without fused rotary and the projection
              kernel in RMS mode, 24 x 32 each, counted apart from the rotary
              and layernorm launches), a profiled request as in the main
              phase, then one socket-server request;
9. e2tts-int8 -- int8 E2-TTS serving at the same width and depth: the e2tts
              phase's checkpoint quantized at load by
              `F5TTSWrapper("E2TTS_Base", compute_dtype="int8",
              int8_validate=True)` behind the quality gate (at 255 frames),
              the quantized UNetT with its kernels against the plain versions
              at b = 2, n = 767 and at the batch's shape with ERAX_INT8_FF
              unset and set, the int8 feed-forward against its plain version
              at that shape (K 1024, N 4096), one `generate` at NFE 32 with
              the flag unset (no kernel 5) and set (24 x 32 launches of kernel
              5 a chunk, none of kernel 2), then `generate_batch` of eight
              texts in turns bf16 / int8 chain / int8 fused as the int8 phase,
              and a profiled int8 fused batch;
10. compress -- the compression path at F5TTS_v1_Base width: a seeded
              N(0, 0.02) 22-block reference-format checkpoint pruned to 14
              and to 12 blocks by the port's CLI (`python -m
              eraxvif5tts_tpu_torch.compression prune`, two processes side
              by side; the reports and a strict load into the port's DiT
              checked); a `DistillTrainer` with the 22-block teacher (bf16,
              eval: kernels 1 and 2 with `lens=None`), the 14-block student
              (fp32 parameters, bf16 compute, dropout 0.1, blocks
              checkpointed: kernels 4a / 4b / 4c) and a duration predictor:
              the teacher's prediction and the distillation loss and its
              gradients against the plain versions at b = 2, n = 1024, a
              warm-up and three timed steps at 9 x 4096 frames (one with an
              alignment, so the predictor trains) with the launch counters
              checked per step, and one profiled step; the EMA student and
              the predictor exported, then served with the predictor on
              through `F5TTSWrapper("F5TTS_v1_Pruned_14")` at NFE 7 and 16
              and `F5TTSWrapper("F5TTS_v1_Pruned_12")` (the pruned file) at
              NFE 16, three texts each, launches checked per chunk
              (depth x NFE), each chunk's predicted frames and the RTF
              logged, each DiT against its plain version, and one socket
              request to the distilled student.
11. mesh  -- multi-device training and serving on `torch.distributed` at
              full F5TTS_v1_Base width and depth (bf16 compute, dropout 0.1,
              blocks checkpointed): a world of one over NCCL here (one DP
              step, an all-reduce and a barrier through it), then two ranks
              on the one card over gloo (NCCL refuses two ranks on one
              device), spawned as processes of their own: DP 2 (two steps,
              2 x 2048 frames a rank) and TP 2 (one step at 2 x 2048 with 8
              heads and 1024 feed-forward columns a rank, and
              `generate_batch` of four texts at NFE 8, the eager step) held
              against one rank on the same global batch and weights,
              ZeRO-1 at DP 2 against the replicated run, saved after a step
              and resumed in a fresh group whose next step equals the
              run's (the loss bit for bit, the norm and the parameters
              within MESH_RERUN_TOL: the card's backward is not bitwise
              deterministic); each rank's peak memory, its kernels'
              launches (1, 2, 4a-4c) and the shapes and offsets it gave them.
12. eval   -- the eval harness at F5TTS_v1_Base's full width and depth,
              random weights: the eval CLI (`eval_infer_batch.main`, the
              default fp32 wrapper from a reference-format checkpoint, NFE 16,
              a cut) over a six-line seedtts metalst of the bundled clips in
              `RTFMeter`, every wav and the report checked, kernel 1 fp32
              counted 22 x NFE a batch; a batch of three rows at unequal
              lengths under `profiling.device_trace` (kernel 1 fp32 in the
              trace and the counters; the device's busy time against a
              CUDA-event wall), every row against the batch through the
              plain versions and its shortest row against the same prompt
              alone at batch 1, both within FP32_TOL (a control with every
              row at the longest row's keys refused); WER, SIM (a full-size
              random UniSpeech ECAPA checkpoint, card vs CPU, a clip's
              self-similarity) and UTMOS through `eval.__main__.main` with
              injected ASR / UTMOS; the infill arm in bf16 (one utterance x
              two seeds at NFE 8, a cut), its mels against the plain
              versions within DIT_TOL (control: kernel 2 given block 0's
              weights in every block); each check beside a planted fault;
13. project -- the fine-tuning project manager: a `ProjectStore`,
              `vocab_check`, `vocab_extend` of the full-size checkpoint
              (loaded strict), `prune_checkpoint_to_ema` of a trainer
              checkpoint, the settings' argv through the port's finetune
              parser, `TrainingProcess` running `finetune --help`,
              `system_stats`, `ui_test_infer` in bf16 at NFE 8; each check
              beside a planted fault.

The line before the last is a JSON object with each kernel's launches in its
path's phase (serving kernels with fused rotary / layernorm: main; without
rotary / RMS: e2tts; the attention's row at n = 6144: mmdit; kernel 1 fp32
with rotary: the fp32 phase's DiT, without: its MMDiT; int8 feed-forward at
ff_mult 2: int8, at ff_mult 4: e2tts-int8; training kernels: train, their
fp32 modes: train-fp32, both on the joint n = 6144: mmdit-train; kernels 1
(rotary) and 4 at head dim 128 in both dtypes: d128; the gated
residual projection, on no path: kernels), error, times, bound and library
time; the compress phase's
launches (kernels 1, 2 and 4 again) are logged and checked in that phase;
the last line is the device summary.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
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
# fp32: the CUDA cores' FFMA; tf32x3: fp32-accurate products on the tensor
# cores in 3xTF32, three TF32 passes (495 TFLOP/s) per product
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12, "tf32x3": 495e12 / 3}
# int8 feed-forward, |kernel - plain| in units of max |plain|: both sum exactly
# (int32) and round at the same points in IEEE fp32, so the hidden codes must
# be the plain version's bit for bit (a reciprocal-product scale flipped 6e-4
# of them on an H100) and the outputs differ by the bf16 rounding of sums
# taken in another order
INT8_FF_TOL = 1e-2
# Limits near the geometric mean of the error measured on an H100 and a
# control's distance (the plain version with a wrong dropout seed, or with
# wrong attention-dropout keys), which each run checks to exceed the limit:
ATTN_REL_TOL = 3e-2  # kernel 4's output and gradients, relative L2: <= 3.4e-3 vs >= 0.44
LSE_REL_TOL = 1e-5  # the forward's fp32 LSE, relative L2 (H100: <= 3e-7; no seed enters it)
LOSS_TOL = 8e-6  # CFM.loss, kernels vs plain attention, relative: 5.0e-6 vs 1.3e-5
GRAD_TOL = 3.4e-3  # its flattened gradient, relative L2: 2.55e-3 vs 4.5e-3
QKV_GRAD_TOL = 7e-3  # the q / k / v projections' gradient, relative L2: 2.7e-3 vs 1.9e-2
# The distillation loss is logged beside its gradients, not held: wrong
# attention-dropout keys move it by less (5.7e-7 on an H100) than the
# kernels' bf16 rounding does (8.2e-6), so no limit on it can see wrong masks;
# its gradients are held to GRAD_TOL / QKV_GRAD_TOL with the control
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
    or its operations over the card's peak for their type (the tensor cores'
    for bf16, int8 and fp32 in 3xTF32, the CUDA cores' for fp32 on FFMA),
    whichever is larger."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S[kind] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def attention_work(b: int, n: int, h: int, d: int, lens, rope: bool,
                   itemsize: int = 2) -> tuple[float, float]:
    """(bytes, operations) of one serving attention on these inputs: q, k, v
    read and the output written in their dtype (``itemsize`` bytes), the
    lengths and the fp32 cos / sin tables read; QK^T and PV over each
    sample's valid keys (a sample with no valid key averages every key)."""
    keys = sum(n if length <= 0 else min(length, n) for length in lens)
    return (4 * b * n * h * d * itemsize + b * 4 + (2 * n * d * 4 if rope else 0),
            4.0 * h * d * n * keys)


def compare(name: str, got, want, tol: float = TOL) -> float:
    import torch

    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = tol * (1 + want.float().abs())
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    if not torch.all(err <= bound):
        raise AssertionError(f"{name}: max |kernel - plain| {float(err.max()):.4g} beyond "
                             f"{tol} * (1 + |plain|)")
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
        if any(mark in line for mark in ("registers", "spill", "Compiling entry",
                                         "Performance Loss")):
            log(f"[build]   {line.strip()}")
    import torch

    probe = torch.empty((2, 4096, 16, 64), dtype=torch.bfloat16, device="cuda")
    ns = kernels.lib.erax_tensor_map_encode_ns(probe.data_ptr(), 2, 4096, 16, 1000)
    if ns < 0:
        raise RuntimeError("libcuda's cuTensorMapEncodeTiled refused a [2, 4096, 16, 64] map")
    log(f"[build] one TMA tensor-map encode on the host: {ns / 1e3:.2f} us (three an attention "
        "forward launch, four a backward launch, one a fused projection (its weight's map is "
        "kept per weight), made per call)")


def check_serving_attention_edges(dev, name: str, with_rope: bool) -> float:
    """The serving attention against its plain version where its blocks and
    tiles end unevenly: n = 64 (one warpgroup), 192 (one full block), 256 and
    1088 (the last 192-row block keeps one warpgroup), each with a
    length that ends inside a tile beside one with no valid key, with lengths
    on a tile's edge beside a full one, and without lengths; a second call
    must give the same bits. Returns the largest error."""
    import torch

    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    gen = torch.Generator(device=dev).manual_seed(SEED + 60 + int(with_rope))
    worst = 0.0
    for n in (64, 192, 256, 1088):
        q, k, v = (torch.randn((3, n, 16, 64), generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        rope = rotary_freqs(n, 64, device=dev) if with_rope else None
        edge = 64 * max(n // 128, 1)
        for lens_list in ([n - 37, 0, 1], [edge, n, 64], None):
            lens = None if lens_list is None else torch.tensor(lens_list, device=dev)
            got = sa.serving_attention(q, k, v, lens, rope)
            worst = max(worst, compare(f"{name} n={n} lens={lens_list}", got,
                                       sa.serving_attention_reference(q, k, v, lens, rope)))
            if not torch.equal(got, sa.serving_attention(q, k, v, lens, rope)):
                raise AssertionError(f"{name} n={n} lens={lens_list}: a second call differs")
    log(f"[kernels] {name} b=3 n=64, 192, 256, 1088, lens inside a tile / 0 / 1, on a tile's "
        f"edge / n / 64, and None: max_abs_err {worst:.3g} (tol {TOL} * (1 + |plain|)), every "
        "second call bit-identical")
    return worst


JOINT_N = 6144  # the MMDiT's longest joint sequence: text bucket 2048 + mel bucket 4096
JOINT_LENS = (6144, 2048 + 1051)  # a full sample; one with 1051 of 4096 mel frames


def check_serving_attention_joint(dev) -> dict:
    """Kernel 1 at the top of its widened domain, the MMDiT's joint sequence
    n = 6144 at b = 2 (lens 6144 and 2048 + 1051), without rotary (the
    MMDiT's mode) and with it: each against its plain version, a second call
    bit-identical, the kernel, the plain version and
    `scaled_dot_product_attention` on the same q, k, v and key mask (without
    the rotation: no library call applies it) timed, the bound computed from
    these inputs. Returns the JSON row's numbers of the mode without rotary."""
    import torch
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    n = JOINT_N
    if n != sa.MAX_N:
        raise AssertionError(f"kernel 1's bound is {sa.MAX_N}, the joint bucket {n}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    q, k, v = (torch.randn((2, n, 16, 64), generator=gen, device=dev).bfloat16()
               for _ in range(3))
    lens = torch.tensor(JOINT_LENS, device=dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    key_mask = (torch.arange(n, device=dev)[None] < lens[:, None])[:, None, None, :]
    row = None
    for with_rope in (False, True):
        rope = rotary_freqs(n, 64, device=dev) if with_rope else None
        name = f"serving_attention n={n} rope {'fused' if with_rope else 'None'}"
        got = sa.serving_attention(q, k, v, lens, rope)
        err = compare(name, got, sa.serving_attention_reference(q, k, v, lens, rope))
        if not torch.equal(got, sa.serving_attention(q, k, v, lens, rope)):
            raise AssertionError(f"{name}: a second call on the same inputs differs")
        ms = cuda_median_ms(lambda: sa.serving_attention(q, k, v, lens, rope))
        plain_ms = cuda_median_ms(lambda: sa.serving_attention_reference(q, k, v, lens, rope),
                                  iters=5, warmup=1)
        library_ms = cuda_median_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_mask))
        least = bound(*attention_work(2, n, 16, 64, list(JOINT_LENS), with_rope))
        log(f"[kernels] {name} b=2 h=16 d=64 lens={list(JOINT_LENS)}: max_abs_err {err:.3g} "
            f"(tol {TOL} * (1 + |plain|)), second call bit-identical; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {least['bound_ms']:.5f} ms by {least['bound_by']} "
            f"({100 * least['bound_ms'] / ms:.1f} % of it), library "
            f"(scaled_dot_product_attention, boolean key mask, no rotation) {library_ms:.4f} ms: "
            f"the kernel takes {ms / library_ms:.2f}x its time")
        if not with_rope:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       **least)
    return row


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
            got = sa.serving_attention(q, k, v, lens, rope)
            err = compare(f"{name} n={n}", got,
                          sa.serving_attention_reference(q, k, v, lens, rope))
            if not torch.equal(got, sa.serving_attention(q, k, v, lens, rope)):
                raise AssertionError(f"{name} n={n}: a second call on the same inputs differs")
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
                   f"{library_ms:.4f} ms: the kernel takes {ms / library_ms:.2f}x its time"
                   if library_ms is not None else ""))
        err_max = max(err_max, check_serving_attention_edges(dev, name, with_rope))
        results[name] = dict(max_abs_err=err_max, **cases[1088])

    edge_err2, edge_err3 = check_fused_projection_edges(dev)
    results.update(check_ln_mod_matmul(dev, g, g_new, edge_err2))
    for name, err in zip(("serving_attention", "ln_mod_matmul"), check_teacher_shapes(dev)):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    results["serving_attention_joint"] = check_serving_attention_joint(dev)
    log("[kernels] the JSON line's serving ms / plain_ms / bound_ms / library_ms are the "
        "n = M = 1088 bucket's; no single PyTorch call computes the attention with rotary, "
        "so its library_ms is null; kernel 2's is the unfused bf16 chain's")
    results.update(check_int8_ff(dev, g))
    results.update(check_matmul_gate_res(dev, g, edge_err3))
    results.update(check_train_attention(dev, g))
    offsets = check_train_attention_offsets(dev, g)
    for name in ("fwd", "dq", "dkv"):
        row = results[f"train_attention_{name}"]
        row["max_abs_err"] = max(row["max_abs_err"], offsets["bfloat16"])
    results.update(check_train_attention_joint(dev))
    return results


def check_teacher_shapes(dev) -> tuple[float, float]:
    """Kernels 1 and 2 at the shapes the distillation teacher's eval forward
    gives them: the attention with rotary and no lengths at b = 9, n = 4096
    (its plain version three samples at a time, bounding the fp32 logits),
    the layernorm projection with GELU on [9, 4096, 1024] -> 2048; a second
    call must give the same bits. Returns the two largest errors."""
    import torch

    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    b, n = TRAIN_BATCH
    q, k, v = (torch.randn((b, n, 16, 64), generator=gen, device=dev).bfloat16()
               for _ in range(3))
    rope = rotary_freqs(n, 64, device=dev)
    got = sa.serving_attention(q, k, v, None, rope)
    want = torch.cat([sa.serving_attention_reference(q[i:i + 3], k[i:i + 3], v[i:i + 3],
                                                     None, rope) for i in range(0, b, 3)])
    err1 = compare(f"serving_attention b={b} n={n} lens=None", got, want)
    if not torch.equal(got, sa.serving_attention(q, k, v, None, rope)):
        raise AssertionError(f"serving_attention b={b} n={n}: a second call differs")
    del q, k, v, got, want
    x = (torch.randn((b, n, 1024), generator=gen, device=dev) + 0.5).bfloat16()
    scale, shift = ((0.1 * torch.randn((b, 1024), generator=gen, device=dev)).bfloat16()
                    for _ in range(2))
    w = (torch.randn((2048, 1024), generator=gen, device=dev) / 32).bfloat16()
    bias = (0.1 * torch.randn((2048,), generator=gen, device=dev)).bfloat16()
    got = fm.ln_mod_matmul(x, scale, shift, w, bias)
    err2 = compare(f"ln_mod_matmul B={b} M={n}", got,
                   fm.ln_mod_matmul_reference(x, scale, shift, w, bias))
    if not torch.equal(got, fm.ln_mod_matmul(x, scale, shift, w, bias)):
        raise AssertionError(f"ln_mod_matmul B={b} M={n}: a second call differs")
    log(f"[kernels] the distillation teacher's shapes: serving_attention b={b} n={n} rope fused, "
        f"lens=None: max_abs_err {err1:.3g}; ln_mod_matmul B={b} M={n} K=1024 N=2048 ln "
        f"gelu_tanh: max_abs_err {err2:.3g} (tol {TOL} * (1 + |plain|)), second calls "
        "bit-identical")
    return err1, err2


def unfused_ln_mod_chain(x, scale, shift, w, bias, norm: str):
    """What a user without kernel 2 would run, in bf16: the norm, the
    modulation, `F.linear`, the tanh-GELU, each a pass through device
    memory. A yardstick only: nothing in the port calls it."""
    import torch
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops.fused_matmul import EPS

    if norm == "ln":
        h = F.layer_norm(x, (x.shape[-1],), eps=EPS["ln"])
    else:
        h = (x.float() * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True) + EPS["rms"])).to(
            x.dtype)
    h = h * (1 + scale[:, None, :]) + shift[:, None, :]
    return F.gelu(F.linear(h, w, bias), approximate="tanh")


def check_fused_projection_edges(dev) -> tuple[float, float]:
    """Kernels 2 and 3 against their plain versions where the GEMM core's
    tiles end unevenly: M = 1, 63, 64, 65, 129 (just past a tile) and 767 at
    the DiT's widths, K = 768 with N = 1536 (F5TTS_Small) and 3072
    (E2TTS_Small) and their transposes for kernel 3; kernel 2 in both modes
    with and without the GELU; kernel 3 masked and not, with lengths of 0, of
    M and inside a tile, the masked rows equal to the residual bit for bit; a
    second call must give the same bits. Returns the largest errors."""
    import torch

    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm

    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    rows = (1, 63, 64, 65, 129, 767)
    worst2 = worst3 = 0.0
    b = 3
    for k, n, ms in ((1024, 2048, rows), (768, 1536, (65, 767)), (768, 3072, (65, 767))):
        w = (randn(n, k) / 32).bfloat16()
        bias = (0.1 * randn(n)).bfloat16()
        for m in ms:
            x = (randn(b, m, k) + 0.5).bfloat16()
            scale, shift = (0.1 * randn(b, k)).bfloat16(), (0.1 * randn(b, k)).bfloat16()
            for norm in ("ln", "rms"):
                for activation in ("gelu_tanh", None):
                    kw = dict(activation=activation, norm=norm)
                    name = f"ln_mod_matmul B={b} M={m} K={k} N={n} {norm} {activation}"
                    got = fm.ln_mod_matmul(x, scale, shift, w, bias, **kw)
                    worst2 = max(worst2, compare(name, got, fm.ln_mod_matmul_reference(
                        x, scale, shift, w, bias, **kw)))
                    if not torch.equal(got, fm.ln_mod_matmul(x, scale, shift, w, bias, **kw)):
                        raise AssertionError(f"{name}: a second call differs")
    for k, n, ms in ((2048, 1024, rows), (1536, 768, (65, 767)), (3072, 768, (65, 767))):
        w = (randn(n, k) / 45).bfloat16()
        bias = (0.1 * randn(n)).bfloat16()
        for m in ms:
            h, res = randn(b, m, k).bfloat16(), randn(b, m, n).bfloat16()
            gate = randn(b, n).bfloat16()
            lens_list = [0, m, max(m - 37, m // 2)]
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            for mask_rows in (True, False):
                args = (h, w, bias, gate, res, lens, mask_rows)
                name = f"matmul_gate_res B={b} M={m} K={k} N={n} lens={lens_list} mask={mask_rows}"
                got = fm.matmul_gate_res(*args)
                worst3 = max(worst3, compare(name, got, fm.matmul_gate_res_reference(*args)))
                if not torch.equal(got, fm.matmul_gate_res(*args)):
                    raise AssertionError(f"{name}: a second call differs")
                if mask_rows and not all(torch.equal(got[i, n_valid:], res[i, n_valid:])
                                         for i, n_valid in enumerate(lens_list)):
                    raise AssertionError(f"{name}: masked rows are not the residual")
    log(f"[kernels] kernels 2 and 3 at b=3, M = 1, 63, 64, 65, 129, 767 (K 1024 / N 2048 and "
        f"back) and M = 65, 767 at K 768 / N 1536, 3072 and back, kernel 2 ln / rms with and "
        f"without GELU, kernel 3 masked (lens 0, M, inside a tile) and not: max_abs_err "
        f"{worst2:.3g} and {worst3:.3g} (tol {TOL} * (1 + |plain|)), every second call "
        "bit-identical, masked rows the residual bit for bit")
    return worst2, worst3


def check_ln_mod_matmul(dev, g, g_new, edge_err: float) -> dict:
    """Kernel 2: the layernorm mode at the DiT's FF width, then the RMS mode
    at the UNetT's (scale = g - 1 with g ~ 1 + 0.1 N(0, 1), shift = 0, one
    all-zero row, which must come out as act(bias)), at b = 2 (one utterance
    with CFG) and at 16 x 768, the shape a `generate_batch` of eight gives it.
    Yardsticks, used nowhere in the port: the unfused bf16 chain, and
    `F.linear` alone on an activation normalised beforehand (the product
    without the fusion). ``edge_err`` is the error at the uneven edges
    (`check_fused_projection_edges`)."""
    import torch
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm

    results = {}
    for name, norm, n_out in (("ln_mod_matmul", "ln", 2048), ("ln_mod_matmul_rms", "rms", 4096)):
        err_max, cases, gen = 0.0, {}, g if norm == "ln" else g_new
        for b, m in ((2, 256), (2, 1088), (16, 768)):
            x = (torch.randn((b, m, 1024), generator=gen, device=dev) + 0.5).bfloat16()
            scale = (0.1 * torch.randn((b, 1024), generator=gen, device=dev)).bfloat16()
            shift = (0.1 * torch.randn((b, 1024), generator=gen, device=dev)).bfloat16()
            w = (torch.randn((n_out, 1024), generator=gen, device=dev) / 32).bfloat16()
            bias = (0.1 * torch.randn((n_out,), generator=gen, device=dev)).bfloat16()
            if norm == "rms":
                x[1, m // 2] = 0.0
                scale, shift = scale[:1].expand(b, -1).contiguous(), torch.zeros_like(shift)
            args = (x, scale, shift, w, bias)
            got = fm.ln_mod_matmul(*args, norm=norm)
            err = compare(f"{name} B={b} M={m}", got,
                          fm.ln_mod_matmul_reference(*args, norm=norm))
            if norm == "rms" and not torch.equal(
                    got[1, m // 2], F.gelu(bias.float(), approximate="tanh").bfloat16()):
                raise AssertionError(f"{name} B={b} M={m}: the all-zero row is not gelu(bias)")
            if not torch.equal(got, fm.ln_mod_matmul(*args, norm=norm)):
                raise AssertionError(f"{name} B={b} M={m}: a second call differs")
            err_max = max(err_max, err)
            ms = cuda_median_ms(lambda: fm.ln_mod_matmul(*args, norm=norm))
            plain_ms = cuda_median_ms(lambda: fm.ln_mod_matmul_reference(*args, norm=norm))
            chain_ms = cuda_median_ms(lambda: unfused_ln_mod_chain(*args, norm))
            normed = F.layer_norm(x, (x.shape[-1],))
            linear_ms = cuda_median_ms(lambda: F.linear(normed, w))
            least = bound(2 * (b * m * 1024 + 2 * b * 1024 + n_out * 1024 + n_out
                               + b * m * n_out), 2.0 * b * m * 1024 * n_out)
            cases[(b, m)] = dict(ms=ms, plain_ms=plain_ms, library_ms=chain_ms, **least)
            log(f"[kernels] {name} B={b} M={m} K=1024 N={n_out} norm {norm} gelu_tanh: "
                f"max_abs_err {err:.3g} (tol {TOL} * (1 + |plain|)); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {least['bound_ms']:.5f} ms by {least['bound_by']}; "
                f"library: the unfused bf16 chain (norm, modulate, F.linear, F.gelu) "
                f"{chain_ms:.4f} ms, the kernel takes {ms / chain_ms:.2f}x its time; F.linear "
                f"alone on a normalised activation (the product without the fusion) "
                f"{linear_ms:.4f} ms")
        results[name] = dict(max_abs_err=max(err_max, edge_err), **cases[(2, 1088)])
    return results


def int8_chain(x, w1_q, s1, b1, w2_q, s2, b2):
    """The quantized block's unfused feed-forward (`ERAX_INT8_FF` unset): two
    QuantLinear products with bf16 outputs and biases, tanh-GELU in bf16. A
    two-product chain of PyTorch calls, timed as kernel 5's library yardstick."""
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops.quant import int8_matmul

    h = F.gelu(int8_matmul(x, w1_q, s1) + b1.bfloat16(), approximate="tanh")
    return int8_matmul(h, w2_q, s2) + b2.bfloat16()


def int8_ff_operands(dev, g, b: int, m: int, k: int, n: int) -> tuple:
    """Seeded operands of kernel 5 at [b, m, k] x n -> k (per-channel int8
    weights of N(0, 1) / 32 and / 45 draws, fp32 biases of 0.1 N(0, 1))."""
    import torch

    from eraxvif5tts_tpu_torch.ops import quant

    x = torch.randn((b, m, k), generator=g, device=dev).bfloat16()
    w1_q, s1 = quant.quantize_weight(torch.randn((n, k), generator=g, device=dev) / 32)
    w2_q, s2 = quant.quantize_weight(torch.randn((k, n), generator=g, device=dev) / 45)
    b1 = 0.1 * torch.randn((n,), generator=g, device=dev)
    b2 = 0.1 * torch.randn((k,), generator=g, device=dev)
    return x, w1_q, s1, b1, w2_q, s2, b2


def int8_ff_work(rows: int, k: int, n: int) -> tuple[float, float]:
    """(bytes, operations) of kernel 5 on ``rows`` rows: x in and the output
    out in bf16, both int8 weight matrices, fp32 scales and biases; two int8
    products of rows x k x n."""
    return 2 * rows * k * 2 + 2 * n * k + 2 * (n + k) * 4, 2 * 2.0 * rows * k * n


def check_int8_ff_case(args, tag: str, shape: str) -> float:
    """Kernel 5 against its plain version on ``args``: the output within
    INT8_FF_TOL of its scale, the hidden codes the kernel requantizes equal to
    the plain version's bit for bit, a second call bit-identical. Returns the
    largest |kernel - plain|."""
    import torch

    from eraxvif5tts_tpu_torch.ops import quant_ff

    x, w1_q = args[0], args[1]
    codes = torch.empty((*x.shape[:2], w1_q.shape[0]), dtype=torch.int8, device=x.device)
    got = quant_ff.int8_ff(*args, h_codes=codes)
    want = quant_ff.int8_ff_reference(*args)
    torch.cuda.synchronize()
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got).all() or err > INT8_FF_TOL * scale:
        raise AssertionError(f"{tag} int8_ff {shape}: max |kernel - plain| {err:.4g} beyond "
                             f"{INT8_FF_TOL} x {scale:.4g}")
    flipped = int((codes != quant_ff.hidden_codes(*args[:4])[0]).sum())
    if flipped:
        raise AssertionError(f"{tag} int8_ff {shape}: {flipped} hidden codes differ from the "
                             "plain version's")
    if not torch.equal(got, quant_ff.int8_ff(*args)):
        raise AssertionError(f"{tag} int8_ff {shape}: a second call differs")
    return err


def check_int8_ff_shape(dev, g, b: int, m: int, tag: str = "[kernels]", k: int = 1024,
                        n: int = 2048) -> tuple:
    """Kernel 5 at [b, m, k] x n -> k (`check_int8_ff_case`), timed beside its
    bound, its plain version and two yardsticks used nowhere in the port: the
    QuantLinear chain the model runs without ERAX_INT8_FF (its library
    time), and `torch._int_mm` alone for the two products on codes made
    beforehand (the bare int8 products without the quantization, the GELU and
    the epilogues). Returns (error, dict of ms / plain_ms / library_ms and the
    bound)."""
    import torch

    from eraxvif5tts_tpu_torch.ops import quant, quant_ff

    args = int8_ff_operands(dev, g, b, m, k, n)
    shape = f"B={b} M={m} K={k} N={n} K2={k}"
    err = check_int8_ff_case(args, tag, shape)
    x, w1_q, s1, b1, w2_q, s2, b2 = args
    x_q = quant.quantize_rows(x.float())[0].view(b * m, k)
    h_q = quant_ff.hidden_codes(*args[:4])[0].view(b * m, n)
    w1_t, w2_t = w1_q.t(), w2_q.t()
    ms = cuda_median_ms(lambda: quant_ff.int8_ff(*args))
    plain_ms = cuda_median_ms(lambda: quant_ff.int8_ff_reference(*args))
    chain_ms = cuda_median_ms(lambda: int8_chain(*args))
    int_mm_ms = cuda_median_ms(lambda: (torch._int_mm(x_q, w1_t), torch._int_mm(h_q, w2_t)))
    least = bound(*int8_ff_work(b * m, k, n), "int8")
    log(f"{tag} int8_ff {shape}: max_abs_err {err:.3g} (tol {INT8_FF_TOL} of the output's scale); "
        f"hidden codes bit-identical, second call bit-identical; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {least['bound_ms']:.5f} ms by {least['bound_by']} (int8 "
        f"peak); library: the QuantLinear chain (two-product chain) {chain_ms:.4f} ms, the "
        f"kernel takes {ms / chain_ms:.2f}x its time; torch._int_mm alone for the two products "
        f"{int_mm_ms:.4f} ms")
    return err, dict(ms=ms, plain_ms=plain_ms, library_ms=chain_ms, **least)


INT8_FF_WIDTHS = {"int8_ff": (1024, 2048), "int8_ff_ffmult4": (1024, 4096)}


def check_int8_ff(dev, g) -> dict:
    """Kernel 5 at ff_mult 2 (K 1024, N 2048) and ff_mult 4 (K 1024, N 4096;
    K 768, N 3072) at b = 2 (one utterance with CFG) at M = 256 and 1088 and
    at 16 x 768 (a batch of eight with CFG), then where its 64-row tiles end
    unevenly (R = 1, 63, 64, 65, 129, 767); the int8 phases add the shapes
    their batches give it. The JSON rows are the B = 2, M = 1088 cases of
    N 2048 (`int8_ff`) and N 4096 (`int8_ff_ffmult4`)."""
    results, worst = {}, {}
    for k, n in ((1024, 2048), (1024, 4096), (768, 3072)):
        cases = {(b, m): check_int8_ff_shape(dev, g, b, m, k=k, n=n)
                 for b, m in ((2, 256), (2, 1088), (16, 768))}
        edge_err = max(check_int8_ff_case(int8_ff_operands(dev, g, 1, m, k, n), "[kernels]",
                                          f"R={m} K={k} N={n}")
                       for m in (1, 63, 64, 65, 129, 767))
        log(f"[kernels] int8_ff K={k} N={n} at R = 1, 63, 64, 65, 129, 767: max_abs_err "
            f"{edge_err:.3g} (tol {INT8_FF_TOL} of the output's scale), hidden codes and second "
            "calls bit-identical")
        worst[(k, n)] = max(edge_err, *(err for err, _ in cases.values()))
        for name, width in INT8_FF_WIDTHS.items():
            if width == (k, n):
                results[name] = dict(max_abs_err=worst[(k, n)], **cases[(2, 1088)][1])
    log("[kernels] the JSON line's int8_ff / int8_ff_ffmult4 ms / plain_ms / bound_ms / "
        "library_ms are the B = 2, M = 1088 cases at N = 2048 and 4096; library_ms is the "
        "QuantLinear chain's (two products, no single PyTorch call computes it)")
    return results


def check_matmul_gate_res(dev, g, edge_err: float) -> dict:
    """Kernel 3 against its plain version at the DiT's FF output shape
    ([2, M, 2048] -> 1024, and 16 x 768 rows), rows past lens kept as the
    residual and not. No model calls it (as in the JAX package), so its
    launches are this check's. Yardsticks, used nowhere in the port: the
    unfused bf16 chain (`F.linear`, then one `addcmul` of gate and residual,
    the row mask folded into the gate) and `F.linear` alone. ``edge_err`` is
    the error at the uneven edges (`check_fused_projection_edges`)."""
    import torch
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm

    fm.matmul_gate_res.launches = 0
    err_max, times = edge_err, {}
    for b, m in ((2, 256), (2, 1088), (16, 768)):
        h = torch.randn((b, m, 2048), generator=g, device=dev).bfloat16()
        w = (torch.randn((1024, 2048), generator=g, device=dev) / 45).bfloat16()
        bias = (0.1 * torch.randn((1024,), generator=g, device=dev)).bfloat16()
        gate = torch.randn((b, 1024), generator=g, device=dev).bfloat16()
        res = torch.randn((b, m, 1024), generator=g, device=dev).bfloat16()
        lens_list = [m, m - 37] * (b // 2)
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        for mask_rows in (True, False):
            args = (h, w, bias, gate, res, lens, mask_rows)
            got = fm.matmul_gate_res(*args)
            err = compare(f"matmul_gate_res B={b} M={m} mask_rows={mask_rows}", got,
                          fm.matmul_gate_res_reference(*args))
            if mask_rows and not torch.equal(got[1, m - 37:], res[1, m - 37:]):
                raise AssertionError(f"matmul_gate_res M={m}: masked rows are not the residual")
            err_max = max(err_max, err)
            gates = gate[:, None, :]
            if mask_rows:
                gates = gates * (torch.arange(m, device=dev)[None, :, None]
                                 < lens[:, None, None]).to(gate.dtype)
            ms = cuda_median_ms(lambda: fm.matmul_gate_res(*args))
            plain_ms = cuda_median_ms(lambda: fm.matmul_gate_res_reference(*args))
            chain_ms = cuda_median_ms(lambda: torch.addcmul(res, gates, F.linear(h, w, bias)))
            linear_ms = cuda_median_ms(lambda: F.linear(h, w))
            # h, the weight, bias, gate, the residual in and the output out in bf16,
            # the lengths; the product over the rows below each sample's length
            rows = sum(lens_list) if mask_rows else b * m
            least = bound(2 * (b * m * 2048 + 1024 * 2048 + 1024 + b * 1024 + 2 * b * m * 1024)
                          + 4 * b, 2.0 * rows * 2048 * 1024)
            times[(b, m, mask_rows)] = dict(ms=ms, plain_ms=plain_ms, library_ms=chain_ms, **least)
            log(f"[kernels] matmul_gate_res B={b} M={m} K=2048 N=1024 mask_rows={mask_rows} "
                f"(lens [{m}, {m - 37}] x {b // 2}): max_abs_err {err:.3g} (tol {TOL} * "
                f"(1 + |plain|)); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{least['bound_ms']:.5f} ms by {least['bound_by']}; library: the unfused bf16 "
                f"chain (F.linear, addcmul) {chain_ms:.4f} ms, the kernel takes "
                f"{ms / chain_ms:.2f}x its time; F.linear alone {linear_ms:.4f} ms")
    log("[kernels] the JSON line's matmul_gate_res ms / plain_ms / bound_ms / library_ms are the "
        "B = 2, M = 1088 masked case's; its launches are the kernel phase's (no model path "
        "calls it)")
    return {"matmul_gate_res": dict(max_abs_err=err_max, launches=fm.matmul_gate_res.launches,
                                    **times[(2, 1088, True)])}


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


def plain_lse(q, k, lens):
    """log sum exp of the masked, scaled logits in fp32, ``[b, h, n]``, one
    sample at a time; a sample with no valid key has log n (every logit equal)."""
    import torch

    n, scale = q.shape[1], 1.0 / math.sqrt(q.shape[-1])
    rows = []
    for i in range(q.shape[0]):
        s = torch.einsum("qhd,khd->hqk", q[i].float(), k[i].float()) * scale
        length = n if lens is None else int(lens[i])
        if 0 < length < n:
            s[..., length:] = -1e30
        rows.append(torch.logsumexp(s, dim=-1) if length > 0
                    else torch.full_like(s[..., 0], math.log(n)))
    return torch.stack(rows)


def check_train_attention_case(q, k, v, dout, lens, rate: float, seed: int) -> dict:
    """Kernel-4 output and gradients against the plain version on one input:
    each within ``TOL * (1 + |plain|)`` element by element and within
    ``ATTN_REL_TOL`` relative L2 error. At dropout > 0 the plain version with
    the next seed is the control: its relative L2 distance from the plain
    version must exceed ``ATTN_REL_TOL``, or the check could not see a wrong
    mask. A second forward and backward on the same inputs must be
    bit-identical. Returns the largest elementwise error, the relative errors
    and the controls."""
    import torch

    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask

    b, n = q.shape[:2]
    mask = None if lens is None else lens_to_mask(lens, n)

    def kernel(*a):
        return ta.train_attention(*a, key_valid=mask, dropout_rate=rate, seed=seed)

    got = attention_grads(kernel, q, k, v, dout)
    want = plain_attention_grads(q, k, v, dout, lens, rate, seed)
    tag = f"b={b} n={n} lens {None if lens is None else lens.tolist()} dropout {rate}"
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
    # the forward's LSE (the undropped weights' normaliser, which the backward
    # reads): fp32 on both sides from the same bf16 inputs, so only the
    # summation order and the base-2 exponentials differ
    lens_i = (torch.full((b,), n, dtype=torch.int32, device=q.device) if lens is None
              else lens)
    out, lse = ta.flash_forward(q, k, v, lens_i, rate, seed)
    rel["lse"] = rel_l2(lse, plain_lse(q, k, lens))
    log(f"[kernels] train_attention {tag}: forward LSE relative L2 error {rel['lse']:.3g} "
        f"(tol {LSE_REL_TOL})")
    if not rel["lse"] <= LSE_REL_TOL:
        raise AssertionError(f"train_attention LSE {tag}: relative L2 error {rel['lse']:.3g} "
                             f"beyond {LSE_REL_TOL}")
    again = ta.flash_forward(q, k, v, lens_i, rate, seed)
    if not (torch.equal(out, got[0]) and torch.equal(again[0], out)
            and torch.equal(again[1], lse)):
        raise AssertionError(f"train_attention {tag}: a second forward with the same seed "
                             "differs in O or LSE")
    # two kernels and no atomics: a second backward gives the same bits
    for name, g, again in zip(names, got, attention_grads(kernel, q, k, v, dout)):
        if not torch.equal(g, again):
            raise AssertionError(f"train_attention {name} {tag}: a second backward on the "
                                 "same inputs differs")
    return dict(abs_err=abs_err, rel=rel, control=control)


# a rank's slice of a whole batch for kernel 4's offsets: rows 3-4 of 5 (data
# parallel) and heads 8-15 of 16 (tensor parallel), n = 256
OFFSET_WHOLE = (5, 256, 16)
OFFSET_ROWS, OFFSET_HEADS = (3, 5), (8, 16)


def check_train_attention_offsets(dev, g) -> dict:
    """Kernels 4a / 4b / 4c on a rank's slice of a batch, with the slice's
    batch and head offsets (3, 8), in bf16 and fp32 at dropout 0.1: O, dq,
    dk and dv equal bit for bit to the same elements of the whole batch's
    launch, and within ``ATTN_REL_TOL`` (relative L2) of the plain version
    at the offsets (fp32's with TF32 off); the same launch without offsets
    as a control, beyond the limit. Times of the slice's forward and
    backward with and without the offsets. Returns the errors by dtype."""
    import torch

    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask

    b, n, h = OFFSET_WHOLE
    (r0, r1), (h0, h1) = OFFSET_ROWS, OFFSET_HEADS
    rate, seed = 0.1, 0x0FF5E7
    names = ("fwd", "dq", "dk", "dv")
    lens = torch.tensor([256, 219, 256, 200, 131], dtype=torch.int32, device=dev)
    out = {}

    def grads(t, lens_t, offsets, plain=False):
        mask = lens_to_mask(lens_t, n)
        if plain:
            return attention_grads(lambda *a: ta.train_attention_reference(
                *a, lens_t, rate, seed, *offsets), *t)
        return attention_grads(lambda *a: ta.train_attention(
            *a, key_valid=mask, dropout_rate=rate, seed=seed, batch_offset=offsets[0],
            head_offset=offsets[1]), *t)

    for dtype in (torch.bfloat16, torch.float32):
        whole = [torch.randn((b, n, h, 64), generator=g, device=dev).to(dtype)
                 for _ in range(4)]
        part = [t[r0:r1, :, h0:h1].contiguous() for t in whole]
        part_lens = lens[r0:r1].contiguous()
        want_whole = grads(whole, lens, (0, 0))
        got = grads(part, part_lens, (r0, h0))
        for name, w, p_ in zip(names, want_whole, got):
            if not torch.equal(w[r0:r1, :, h0:h1], p_):
                raise AssertionError(f"train_attention {dtype} {name}: the slice at offsets "
                                     f"({r0}, {h0}) differs from the whole batch's launch")
        with tf32(False):
            plain = grads(part, part_lens, (r0, h0), plain=True)
        rel = {name: rel_l2(x, y) for name, x, y in zip(names, got, plain)}
        control = {name: rel_l2(x, y) for name, x, y in
                   zip(names, grads(part, part_lens, (0, 0)), plain)}
        if any(r > ATTN_REL_TOL for r in rel.values()) or any(
                c <= ATTN_REL_TOL for c in control.values()):
            raise AssertionError(f"train_attention {dtype} at offsets ({r0}, {h0}): relative "
                                 f"L2 {rel}, control without offsets {control}, tol "
                                 f"{ATTN_REL_TOL}")
        q, k, v, dout = part
        fwd = ta.flash_forward if dtype == torch.bfloat16 else ta.flash_forward_fp32
        dq_k, dkv_k = ((ta.flash_dq, ta.flash_dkv) if dtype == torch.bfloat16
                       else (ta.flash_dq_fp32, ta.flash_dkv_fp32))
        o, lse = fwd(q, k, v, part_lens, rate, seed, offsets=(r0, h0))
        dd = ta.row_dot(dout, o)
        ms = {}
        for offsets in ((r0, h0), (0, 0)):
            ms[offsets] = [cuda_median_ms(lambda: fwd(q, k, v, part_lens, rate, seed,
                                                      offsets=offsets)),
                           cuda_median_ms(lambda: dq_k(q, k, v, part_lens, lse, dd, dout, rate,
                                                       seed, offsets=offsets)),
                           cuda_median_ms(lambda: dkv_k(q, k, v, part_lens, lse, dd, dout, rate,
                                                        seed, offsets=offsets))]
        log(f"[kernels] train_attention {str(dtype)[6:]} on a rank's slice (rows {r0}-{r1 - 1} "
            f"of {b}, heads {h0}-{h1 - 1} of {h}, n = {n}, dropout {rate}) at offsets "
            f"({r0}, {h0}): O, dq, dk, dv bit for bit the whole batch's; relative L2 vs plain "
            + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in rel.items())
            + f" (tol {ATTN_REL_TOL}); control without offsets "
            + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in control.items())
            + "; fwd / dq / dk-dv ms at the offsets "
            + " / ".join(f"{t:.4f}" for t in ms[(r0, h0)]) + ", without "
            + " / ".join(f"{t:.4f}" for t in ms[(0, 0)]))
        out[str(dtype)[6:]] = max(compare(f"train_attention offsets {dtype} {name}", x, y)
                                  for name, x, y in zip(names, got, plain))
    return out


def check_train_attention(dev, g) -> dict:
    """The training attention's three kernels against the plain version and
    its autograd, forward output and q / k / v gradients, dropout on and off:
    b = 2 with a masked sample at n = 256, 1024 and 4096, the shapes that do
    not fill the backward's 128-row blocks (n = 192 with a masked sample,
    n = 4032 with a masked sample and one with no valid key), then the train
    phase's own shape (9 x 4096, no mask). Times at b = 2 and n = 256, 1024,
    4096, at dropout 0.1 (what the path trains at) and at keep = 1 (what the
    library's attention computes: the factor against it is like for like)."""
    import torch

    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    rel_max, control_min = {}, {}
    times = {}
    b_path, n_path = TRAIN_BATCH
    cases = ((2, 192, [192, 155]), (2, 256, [256, 219]), (2, 1024, [1024, 987]),
             (3, 4032, [4032, 0, 3995]), (2, 4096, [4096, 4059]), (b_path, n_path, None))
    for b, n, lens_list in cases:
        q, k, v, dout = (torch.randn((b, n, 16, 64), generator=g, device=dev).bfloat16()
                         for _ in range(4))
        lens = (None if lens_list is None
                else torch.tensor(lens_list, dtype=torch.int32, device=dev))
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
        if (b, n) not in ((2, 256), (2, 1024), (2, 4096)):
            continue
        ms, times[n], least, _ = time_train_attention(q, k, v, dout, lens, lens_list, seed)
        plain_fwd, plain_bwd, lib_fwd, lib_bwd = train_attention_yardsticks(times[n])
        keep1 = ms[0.0]
        log(f"[kernels] train_attention b=2 n={n} lens {lens_list}: at dropout 0.1 forward "
            f"{ms[0.1]['fwd']:.4f} ms (plain {plain_fwd:.4f} ms), dq {ms[0.1]['dq']:.4f} ms + "
            f"dk/dv {ms[0.1]['dkv']:.4f} ms (plain backward, all three gradients, "
            f"{plain_bwd:.4f} ms); at keep = 1 forward {keep1['fwd']:.4f} ms, dq "
            f"{keep1['dq']:.4f} ms + dk/dv {keep1['dkv']:.4f} ms; bounds "
            + ", ".join(f"{name} {v['bound_ms']:.5f} ms by {v['bound_by']}"
                        for name, v in least.items())
            + f" (share of the bound at keep = 1: "
            + ", ".join(f"{name} {least[name]['bound_ms'] / keep1[name]:.1%}" for name in least)
            + f"); library scaled_dot_product_attention at keep = 1, no mask: forward "
            f"{lib_fwd:.4f} ms, backward (all three gradients) {lib_bwd:.4f} ms; against it at "
            f"keep = 1 the forward takes {keep1['fwd'] / lib_fwd:.2f}x and dq + dk/dv "
            f"{(keep1['dq'] + keep1['dkv']) / lib_bwd:.2f}x its time")
    log("[kernels] train_attention over every case: largest relative L2 error "
        + ", ".join(f"{name} {r:.3g}" for name, r in rel_max.items())
        + "; smallest control " + ", ".join(f"{name} {c:.3g}" for name, c in control_min.items())
        + f"; tol {ATTN_REL_TOL} between them; every second forward and backward bit-identical")
    log("[kernels] the JSON line's training ms / plain_ms / bound_ms / library_ms are the "
        "b = 2, n = 4096 case's, ms and plain_ms at dropout 0.1 (the path trains at 0.1), "
        "library_ms at keep = 1 (the library has no such dropout: the factors above compare "
        "the keep = 1 times with it); plain_ms and library_ms of dq and dk/dv are the plain "
        "version's and the library's whole backward")
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


@contextlib.contextmanager
def plain_serving_ops():
    """The serving kernels' plain versions in place of the kernels (attention,
    the normalised projection, the int8 feed-forward) inside the block: in
    the DiT's and the UNetT's modules and in the MMDiT's joint attention."""
    from eraxvif5tts_tpu_torch.models import mmdit, modules
    from eraxvif5tts_tpu_torch.ops.fused_matmul import ln_mod_matmul_reference
    from eraxvif5tts_tpu_torch.ops.quant_ff import int8_ff_reference
    from eraxvif5tts_tpu_torch.ops.serving_attention import serving_attention_reference

    def attention(q, k, v, key_valid=None, rope=None):
        lens = None if key_valid is None else key_valid.sum(-1)
        return serving_attention_reference(q, k, v, lens, rope)

    saved = (modules.dot_product_attention, modules.ln_mod_matmul, modules.int8_ff,
             mmdit.dot_product_attention)
    modules.dot_product_attention = mmdit.dot_product_attention = attention
    modules.ln_mod_matmul = ln_mod_matmul_reference
    modules.int8_ff = int8_ff_reference
    try:
        yield
    finally:
        (modules.dot_product_attention, modules.ln_mod_matmul, modules.int8_ff,
         mmdit.dot_product_attention) = saved


def backbone_inputs(dev, b: int, n: int, text_len: int) -> tuple:
    """Seeded inputs of one backbone call: (x, cond, text, drop, mask, time)
    for b rows of n frames and ``text_len`` text ids, the second half of the
    rows with their conditioning dropped (as CFG doubles a batch), every odd
    row masked after n - 56 frames."""
    import torch

    from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((b, n, 100), generator=g, device=dev)
    cond = torch.randn((b, n, 100), generator=g, device=dev)
    text = torch.randint(0, 90, (b, text_len), generator=g, device=dev)
    drop = torch.arange(b, device=dev) >= b // 2
    mask = lens_to_mask(n - 56 * (torch.arange(b, device=dev) % 2), n)
    return x, cond, text, drop, mask, torch.full((b,), 0.3, device=dev)


def run_backbone(net, inputs):
    """One backbone call, ``embed_text`` then ``run``, on :func:`backbone_inputs`."""
    import torch

    x, cond, text, drop, mask, time_ = inputs
    with torch.inference_mode():
        te = net.embed_text(text, x.shape[1], drop)
        return net.run(x, cond, te, time_, drop, mask)


def check_dit_against_plain(dit, dev, tag: str = "[main]", b: int = 2, n: int = 256,
                            text_len: int = 120):
    """One ``run`` of a backbone (DiT, UNetT or MMDiT) at full width with the
    kernels vs with the plain versions, on the same card and
    :func:`backbone_inputs` (the MMDiT's text stream keeps ``text_len``: a
    multiple of 64 there). Returns the largest error in units of the plain
    output's scale."""
    import torch

    inputs = backbone_inputs(dev, b, n, text_len)
    got = run_backbone(dit, inputs)
    with plain_serving_ops():
        want = run_backbone(dit, inputs)
    rel = float((got - want).abs().max() / want.abs().max())
    name = type(dit).__name__
    log(f"{tag} {name}.run b={b} n={n} text {text_len} kernels vs plain versions: max error "
        f"{rel:.3g} of scale {float(want.abs().max()):.3g} (tol {DIT_TOL})")
    if not torch.isfinite(got).all() or rel > DIT_TOL:
        raise AssertionError(f"{name} with kernels differs from plain by {rel:.3g}")
    return rel


def serving_counts() -> dict:
    """The serving kernels' launch counts by mode: attention with fused rotary
    and without, in bf16 and in fp32, the normalised projection in layernorm and in RMS mode, the
    int8 feed-forward."""
    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.ops import quant_ff as qf
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa

    return {"serving_attention": sa.serving_attention.launches_by_rope[True],
            "serving_attention_norope": sa.serving_attention.launches_by_rope[False],
            "serving_attention_fp32": sa.serving_attention.launches_fp32_by_rope[True],
            "serving_attention_fp32_norope": sa.serving_attention.launches_fp32_by_rope[False],
            "ln_mod_matmul": fm.ln_mod_matmul.launches_by_norm["ln"],
            "ln_mod_matmul_rms": fm.ln_mod_matmul.launches_by_norm["rms"],
            "int8_ff": qf.int8_ff.launches}


def reset_serving_counts() -> None:
    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.ops import quant_ff as qf
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa

    sa.serving_attention.launches = fm.ln_mod_matmul.launches = qf.int8_ff.launches = 0
    sa.serving_attention.launches_by_rope = {True: 0, False: 0}
    sa.serving_attention.launches_fp32_by_rope = {True: 0, False: 0}
    fm.ln_mod_matmul.launches_by_norm = {"ln": 0, "rms": 0}


RTF: dict = {}  # tag -> the realtime factor of generate_counted's requests under it


@contextlib.contextmanager
def dispatches(wrapper):
    """Record the duration bucket of every fused-step dispatch of ``wrapper``
    (from any thread) in the list the block gets."""
    buckets = []
    dispatch = wrapper._dispatch_sample_vocode

    def recorded(*args, **kwargs):
        buckets.append(kwargs["max_duration"])
        return dispatch(*args, **kwargs)

    wrapper._dispatch_sample_vocode = recorded
    try:
        yield buckets
    finally:
        del wrapper._dispatch_sample_vocode


def graph_state(wrapper) -> tuple[int, int]:
    """(graphs captured, graph replays) of ``wrapper`` so far."""
    return len(wrapper._graphs), wrapper.graph_replays


def euler_steps(wrapper, before: tuple[int, int], chunks: int, nfe: int) -> tuple[int, int]:
    """(backbone steps the card ran, graphs captured) since ``before`` (a
    :func:`graph_state`) for ``chunks`` dispatches at ``nfe``: a replay a
    chunk runs nfe steps, and the eager run before each capture one. Raises
    unless every chunk was one replay."""
    captured, replays = (now - then for now, then in zip(graph_state(wrapper), before))
    if replays != chunks:
        raise AssertionError(f"{chunks} chunk(s) dispatched, {replays} graph replay(s)")
    return nfe * chunks + captured, captured


def generate_counted(wrapper, ref, texts, nfe: int, tag: str, path: tuple[str, ...]) -> dict:
    """Set the serving counters to 0, `generate` each text and read them:
    per request, the kernels of ``path`` (names of :func:`serving_counts`)
    must each have launched depth times a backbone step the card ran (nfe
    a chunk's replay, one the eager run before each capture of a new key)
    and the other modes not at all. Logs the realtime factor per request and
    keeps the whole call's in ``RTF[tag]``; returns the counts."""
    import numpy as np

    depth = wrapper.config.arch.depth
    reset_serving_counts()
    total_audio = total_wall = 0.0
    with dispatches(wrapper) as buckets:
        for i, text in enumerate(texts):
            n_before, before, graphs = len(buckets), serving_counts(), graph_state(wrapper)
            t0 = time.perf_counter()
            wave = wrapper.generate(text, seed=SEED + i, nfe_step=nfe)
            wall = time.perf_counter() - t0
            chunks = len(buckets) - n_before
            steps, captured = euler_steps(wrapper, graphs, chunks, nfe)
            audio = len(wave) / wrapper.target_sample_rate
            total_audio, total_wall = total_audio + audio, total_wall + wall
            rose = {name: count - before[name] for name, count in serving_counts().items()}
            log(f"{tag} generate #{i}: {chunks} chunk(s) at buckets {buckets[n_before:]}, "
                f"{chunks} graph replay(s), {captured} new graph(s); {audio:.2f} s of "
                f"audio in {wall:.3f} s (RTF {wall / audio:.4f}, {audio / wall:.2f}x "
                f"realtime); launches {rose}")
            if not (np.isfinite(wave).all() and np.abs(wave).max() > 1e-3 and len(wave) > 0):
                raise AssertionError(f"{tag} generate #{i}: PCM is not finite and non-silent")
            want = {name: depth * steps if name in path else 0 for name in rose}
            if rose != want:
                raise AssertionError(f"{tag} generate #{i}: launches {rose}, expected {want} "
                                     f"({depth} x {steps} backbone steps on {path})")
    RTF[tag] = total_wall / total_audio
    log(f"{tag} {len(texts)} request(s): {total_audio:.2f} s of audio in {total_wall:.3f} s: "
        f"RTF {RTF[tag]:.4f} ({total_audio / total_wall:.2f}x realtime) at "
        f"NFE {nfe}, {wrapper.compute_dtype}, batch 1")
    return serving_counts()


KERNEL_GROUPS = (  # device kernels by name, first match
    ("kernel 1 fp32 (attention)", ("serving_attention_fp32_kernel",)),
    ("kernel 1 (attention)", ("serving_attention_kernel",)),
    ("kernel 2 (norm + FF in)", ("ln_mod_matmul_kernel", "row_stats_kernel")),
    ("kernel 3 (gated residual)", ("matmul_gate_res_kernel",)),
    ("kernel 5 (int8 FF)", ("int8_ff_kernel", "quantize_x_kernel")),
    ("kernel 4a (attention forward)", ("train_attention_fwd_kernel",)),
    ("kernel 4b (dq)", ("train_attention_dq_kernel",)),
    ("kernel 4c (dk/dv)", ("train_attention_dkv_kernel",)),
    ("kernel 4a fp32 (attention forward)", ("train_fp32_fwd_kernel",)),
    ("kernel 4b fp32 (dq)", ("train_fp32_dq_kernel", "train_fp32_dq_pairs_kernel")),
    ("kernel 4c fp32 (dk/dv)", ("train_fp32_dkv_kernel", "train_fp32_dkv_pairs_kernel")),
    ("GEMMs", ("gemm", "nvjet", "cutlass", "cublas", "gemv")),
    ("convolutions", ("conv", "cudnn", "fft")),
)
OTHER_KERNELS = "elementwise, reductions, other"


def device_ms_by_group(prof, ranges: tuple[str, ...] = ()) -> tuple[dict, int]:
    """The device kernels of a `torch.profiler` pass, their time summed by
    `KERNEL_GROUPS` (groups that ran no kernel left out), and their number.
    `ranges` names the `record_function` ranges of the pass: the profiler
    shows each on the device too, as one event spanning its kernels, which
    is no kernel."""
    import torch

    groups, launches = {}, 0
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA or event.key in ranges:
            continue
        key = event.key.lower()
        if "memcpy" in key or "memset" in key:
            continue
        group = next((name for name, marks in KERNEL_GROUPS if any(m in key for m in marks)),
                     OTHER_KERNELS)
        groups[group] = groups.get(group, 0.0) + event.self_device_time_total / 1e3
        launches += event.count
    return groups, launches


def profile_generate(wrapper, ref, text, nfe: int, tag: str) -> None:
    """Where one warm `generate` of ``text`` (or, for a list of texts, one
    `generate_batch`) spends its time: the wall of an unprofiled call, then
    a call under `torch.profiler`: the device kernels summed by group, the
    device's busy share of the unprofiled wall, and the host's
    `cudaGraphLaunch` calls, one a chunk (each chunk is one graph replay)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = not isinstance(text, str)

    def call():
        if batch:
            return wrapper.generate_batch(list(text), seed=SEED, nfe_step=nfe)
        return wrapper.generate(text, seed=SEED, nfe_step=nfe)

    call()
    torch.cuda.synchronize()
    before = graph_state(wrapper)
    with dispatches(wrapper) as chunks:
        t0 = time.perf_counter()
        call()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if euler_steps(wrapper, before, len(chunks), nfe)[1]:
        raise AssertionError(f"{tag} the warm call captured a graph")
    # the host's activity too: with one graph replay a chunk it is a few
    # hundred events, not the ~78,000 launches of the MMDiT's eager step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    groups, launches = device_ms_by_group(prof)
    graph_launches = sum(e.count for e in prof.key_averages() if e.key == "cudaGraphLaunch")
    if graph_launches != len(chunks):
        raise AssertionError(f"{tag} {graph_launches} cudaGraphLaunch calls for {len(chunks)} "
                             "chunk(s)")
    device_ms = sum(groups.values())
    what = f"generate_batch of {len(text)} texts" if batch else "generate"
    if device_ms <= 0.0:
        log(f"{tag} profile of one warm {what}: {graph_launches} cudaGraphLaunch for "
            f"{len(chunks)} chunk(s); the profiler recorded no device time; device share "
            "not measured")
        return
    log(f"{tag} profile of one warm {what} at NFE {nfe}, {wrapper.compute_dtype}: wall "
        f"{wall_ms:.1f} ms unprofiled; {graph_launches} cudaGraphLaunch for {len(chunks)} "
        f"chunk(s); {launches} device kernels, {device_ms:.1f} ms of device time = "
        f"{100 * device_ms / wall_ms:.1f} % of the unprofiled wall, "
        f"{100 * device_ms / profiled_ms:.1f} % of the profiled call's {profiled_ms:.1f} ms "
        "(device busy share; tracing slows the graph's kernels); "
        + ", ".join(f"{name} {ms:.1f} ms ({100 * ms / device_ms:.0f} %)"
                    for name, ms in groups.items()))


# The [dispatch] checks' Euler steps: keys of their own, cut from NFE 32 for
# the smoke's time (each key's first call runs one step eagerly, captures the
# whole and replays it; the checks then run it eagerly twice more to compare)
DISPATCH_NFE = 8
# a path's counter -> the device kernel its launches show as in a trace
TRACE_MARKS = {"serving_attention": "serving_attention_kernel",
               "serving_attention_norope": "serving_attention_kernel",
               "serving_attention_fp32": "serving_attention_fp32_kernel",
               "serving_attention_fp32_norope": "serving_attention_fp32_kernel",
               "ln_mod_matmul": "ln_mod_matmul_kernel",
               "ln_mod_matmul_rms": "ln_mod_matmul_kernel",
               "int8_ff": "int8_ff_kernel"}


def graphs_logged(wrapper) -> str:
    """``wrapper``'s graphs and its graph pool's bytes, for a log line."""
    pool = graph_pool_bytes(wrapper)
    return (f"{len(wrapper._graphs)} CUDA graph(s), graph pool "
            + (f"{pool / 2**20:.1f} MiB" if pool is not None else "not measured"))


def graph_pool_bytes(wrapper) -> int | None:
    """Bytes the caching allocator holds in ``wrapper``'s graph pool (None
    where its snapshot names no pools)."""
    import torch

    pool = wrapper._graph_pool
    segments = torch.cuda.memory_snapshot()
    if pool is None or not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def other_reference(ref):
    """A reference of ``ref``'s length with another mel and another RMS: its
    mel reversed in time, its level a quarter of ``ref``'s."""
    return dataclasses.replace(ref, mel=ref.mel.flip(1).contiguous(), rms=0.25 * ref.rms)


def check_dispatch(wrapper, ref, tag: str, per_step: dict) -> None:
    """The fused step's single dispatch on the card (``[dispatch]``): at the two
    smallest duration buckets ``ref`` reaches, DISPATCH_NFE steps, a key's
    first call (a one-step eager run, capture, replay) and a second call (a
    replay) each equal to the eager step on the same inputs, PCM and mel bit for bit, with
    no host cache grown by the capture; under the first key a reference of the
    same length with another mel and RMS equal to its own eager step (an input
    baked into the graph would give it the first's); one replay under
    `torch.profiler`, whose device kernels must show each counter of
    ``per_step`` (a counter: its launches in one backbone call) launched that
    many x DISPATCH_NFE times, as the counters say. Logs the walls, the graphs
    and the pool's bytes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eraxvif5tts_tpu_torch.infer.utils import pick_bucket
    from eraxvif5tts_tpu_torch.infer.wrapper import VOCODE_MARGIN_FRAMES

    dev, n_ref = wrapper.device, ref.n_frames
    vstart = max(n_ref - VOCODE_MARGIN_FRAMES, 0)
    first = wrapper.duration_buckets.index(pick_bucket(n_ref + 1, wrapper.duration_buckets))
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    sway = wrapper.sway_sampling_coef

    def timed_call(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same(got, want) -> bool:
        return all(torch.equal(x, y) for x, y in zip(got, want))

    keyed = []
    for bucket in wrapper.duration_buckets[first:first + 2]:
        text = torch.randint(0, len(VOCAB_CHARS), (1, wrapper.text_buckets[0]), generator=g,
                             device=dev)
        static = dict(steps=DISPATCH_NFE, cfg_strength=float(wrapper.cfg_strength),
                      sway=None if sway is None else float(sway), max_duration=bucket,
                      vocode_start=vstart, gen_start=n_ref - vstart)
        rest = (torch.tensor([max(n_ref + 1, bucket - 3)], device=dev),
                torch.tensor([n_ref], device=dev), wrapper._draw_noise(g, bucket))
        args = (ref.mel, text, *rest, wrapper._rms_scale(ref))
        caches = {name: len(keys) for name, keys in wrapper._host_caches().items()}
        graphs = len(wrapper._graphs)
        got1, first_s = timed_call(wrapper._dispatch_sample_vocode, *args, **static)
        got2, replay_s = timed_call(wrapper._dispatch_sample_vocode, *args, **static)
        want, eager_s = timed_call(wrapper._sample_vocode, *args, **static)
        grown = {name: len(keys) for name, keys in wrapper._host_caches().items()}
        if len(wrapper._graphs) != graphs + 1:
            raise AssertionError(f"{tag} [dispatch] bucket {bucket}: no new graph")
        if not (same(got1, want) and same(got2, want)):
            diff = int((got2[0].int() - want[0].int()).abs().max())
            raise AssertionError(f"{tag} [dispatch] bucket {bucket}: the replay differs from "
                                 f"the eager step (PCM by {diff} LSB at most)")
        log(f"{tag} [dispatch] bucket {bucket}, text {text.shape[1]}, NFE {DISPATCH_NFE}: "
            f"first call (one-step eager run + capture + replay) {first_s:.3f} s, replay "
            f"{replay_s:.3f} s, eager step {eager_s:.3f} s; PCM {tuple(got2[0].shape)} and mel "
            f"{tuple(got2[1].shape)} of both calls equal to the eager step's bit for bit; "
            f"host caches {caches} before, {grown} after")
        keyed.append((args, static, got2))
    args, static, got = keyed[0]
    other = other_reference(ref)
    scales = float(wrapper._rms_scale(ref)), float(wrapper._rms_scale(other))
    if other.n_frames != n_ref or scales[0] == scales[1] or torch.equal(other.mel, ref.mel):
        raise AssertionError(f"{tag} [dispatch] the second reference is not another input of "
                             f"the same key ({other.n_frames} frames, rms scales {scales})")
    args2 = (other.mel, *args[1:5], wrapper._rms_scale(other))
    graphs = len(wrapper._graphs)
    got2 = wrapper._dispatch_sample_vocode(*args2, **static)
    want2 = wrapper._sample_vocode(*args2, **static)
    if len(wrapper._graphs) != graphs or not same(got2, want2) or torch.equal(got2[0], got[0]):
        raise AssertionError(f"{tag} [dispatch] a second reference under the first key does "
                             "not give its own eager step")
    log(f"{tag} [dispatch] a reference of the same {n_ref} frames with another mel and rms "
        f"scale ({scales[1]:.4f} vs {scales[0]:.4f}) under the first key: its replay equals "
        f"its own eager step bit for bit and differs from the first reference's")
    torch.cuda.synchronize()
    before = serving_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wrapper._dispatch_sample_vocode(*args, **static)
        torch.cuda.synchronize()
    rose = {name: count - before[name] for name, count in serving_counts().items()}
    want = {name: per_step.get(name, 0) * DISPATCH_NFE for name in rose}
    counted, traced = {}, {}
    for name in per_step:
        counted[TRACE_MARKS[name]] = counted.get(TRACE_MARKS[name], 0) + rose[name]
    for event in prof.key_averages():
        for mark in counted:
            if event.device_type == torch.autograd.DeviceType.CUDA and mark in event.key:
                traced[mark] = traced.get(mark, 0) + event.count
    if rose != want or traced != counted:
        raise AssertionError(f"{tag} [dispatch] one replay: counters {rose} (expected {want}), "
                             f"device trace {traced} (counters: {counted})")
    pool = graph_pool_bytes(wrapper)
    log(f"{tag} [dispatch] one replay under torch.profiler: device kernels {traced}, equal to "
        f"the counters' {counted} ({DISPATCH_NFE} steps); {len(wrapper._graphs)} graph(s), "
        f"{wrapper.graph_replays} replay(s) so far, graph pool "
        + (f"{pool / 2**20:.1f} MiB" if pool is not None else "not measured")
        + f", {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved in all")


def check_pipeline(wrapper, ref, tag: str) -> None:
    """A `generate` of four chunks or more at NFE 32: one graph replay a chunk,
    never more than three chunks dispatched and not yet fetched when the next
    one is, and its PCM equal bit for bit to the same request's with the
    eager step in place of the dispatch, chunk by chunk."""
    import numpy as np

    from eraxvif5tts_tpu_torch.text.chunk import chunk_text

    max_chars, hard = wrapper._max_chars_for(ref)
    text, i = TEXTS[0], 1
    while len(chunk_text(text, max_chars=max_chars, hard_max=hard)) < 4:
        text, i = f"{text} {TEXTS[i % len(TEXTS)]}", i + 1
    fetch, dispatch = wrapper._fetch_async, wrapper._dispatch_sample_vocode
    fetched, synced, in_flight = [0], [0], []

    class Arrival:
        def __init__(self, event):
            self.event = event

        def synchronize(self):
            synced[0] += 1
            self.event.synchronize()

    def fetch_async(*tensors):
        fetched[0] += 1
        *host, done = fetch(*tensors)
        return (*host, Arrival(done))

    def dispatched(*args, **kwargs):
        in_flight.append(fetched[0] - synced[0])
        return dispatch(*args, **kwargs)

    wrapper._fetch_async, wrapper._dispatch_sample_vocode = fetch_async, dispatched
    before = graph_state(wrapper)
    try:
        t0 = time.perf_counter()
        got = wrapper.generate(text, seed=SEED + 21, nfe_step=NFE)
        wall = time.perf_counter() - t0
    finally:
        del wrapper._fetch_async, wrapper._dispatch_sample_vocode
    chunks = len(in_flight)
    captured = euler_steps(wrapper, before, chunks, NFE)[1]
    if chunks < 4 or in_flight != [min(i, 3) for i in range(chunks)] or synced[0] != chunks:
        raise AssertionError(f"{tag} [dispatch] pipeline: {chunks} chunks, in flight at each "
                             f"dispatch {in_flight}, {synced[0]} fetched")
    wrapper._dispatch_sample_vocode = wrapper._sample_vocode
    try:
        t0 = time.perf_counter()
        want = wrapper.generate(text, seed=SEED + 21, nfe_step=NFE)
        eager = time.perf_counter() - t0
    finally:
        del wrapper._dispatch_sample_vocode
    if not np.array_equal(got, want):
        raise AssertionError(f"{tag} [dispatch] pipeline: the PCM differs from the eager "
                             f"step's by {float(np.abs(got - want).max()):.3g} at most")
    log(f"{tag} [dispatch] generate of {len(text)} chars in {chunks} chunks at NFE {NFE}: "
        f"one graph replay a chunk ({captured} captured here), chunks in flight at each "
        f"dispatch {in_flight}; {len(got) / wrapper.target_sample_rate:.2f} s of audio in "
        f"{wall:.3f} s, equal bit for bit to the eager step's chunk by chunk ({eager:.3f} s)")


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
    warm_smallest(wrapper, ref, nfe_step=2)
    generate_counted(wrapper, ref, TEXTS[:1], BASE_NFE, "[main] F5TTS_Base:",
                     ("serving_attention_norope", "ln_mod_matmul"))


def warm_smallest(wrapper, ref, nfe_step=None) -> list:
    """`F5TTSWrapper.warmup` cut to one step: the smallest duration bucket a
    request with this reference can reach and the smallest text bucket."""
    from eraxvif5tts_tpu_torch.infer.utils import pick_bucket

    bucket = pick_bucket(ref.n_frames + 1, wrapper.duration_buckets)
    return wrapper.warmup(ref, nfe_step=nfe_step, buckets=(bucket,),
                          text_buckets=wrapper.text_buckets[:1])


def phase_main(dev) -> tuple[object, object, dict]:
    wrapper = build_wrapper(dev)
    check_dit_against_plain(wrapper.transformer, dev)

    ref = load_reference(wrapper)
    log(f"[main] reference: {ref.n_frames} frames ({ref.audio_seconds:.2f} s), "
        f"text {ref.text!r}")
    t0 = time.perf_counter()
    warmed = warm_smallest(wrapper, ref)
    log(f"[main] warmup (one NFE-{NFE} step at the smallest (duration, text) buckets "
        f"{warmed}) {time.perf_counter() - t0:.2f} s: {graphs_logged(wrapper)}")
    depth = wrapper.config.arch.depth
    timed("[main] [dispatch]", check_dispatch, wrapper, ref, "[main]",
          {"serving_attention": depth, "ln_mod_matmul": depth})
    counts = generate_counted(wrapper, ref, TEXTS, NFE, "[main]",
                              ("serving_attention", "ln_mod_matmul"))
    launches = {name: counts[name] for name in ("serving_attention", "ln_mod_matmul")}
    timed("[main] [dispatch] pipeline", check_pipeline, wrapper, ref, "[main]")
    profile_generate(wrapper, ref, TEXTS[1], NFE, "[main]")
    check_f5tts_base(dev)
    return wrapper, ref, launches


def phase_server(wrapper, ref, texts=TEXTS, tag: str = "[server]", nfe: int = NFE):
    import numpy as np

    from eraxvif5tts_tpu_torch.serving.socket_server import TTSStreamingProcessor, start_server

    processor = TTSStreamingProcessor(wrapper, ref_state=ref, nfe_step=nfe,
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


HTTP_CHUNK_CHARS = 100  # the HTTP server's text_chunk_size (`ServerConfig` default)
HTTP_SEED = SEED + 7


def multipart_body(fields: dict, boundary: str = "smoke-boundary") -> tuple[bytes, dict]:
    """A multipart/form-data body: bytes values as file fields, the rest text."""
    body = b""
    for name, value in fields.items():
        if isinstance(value, bytes):
            body += (f'--{boundary}\r\ncontent-disposition: form-data; name="{name}"; '
                     f'filename="ref.wav"\r\ncontent-type: audio/wav\r\n\r\n').encode()
            body += value + b"\r\n"
        else:
            body += (f'--{boundary}\r\ncontent-disposition: form-data; name="{name}"'
                     f"\r\n\r\n{value}\r\n").encode()
    return (body + f"--{boundary}--\r\n".encode(),
            {"content-type": f"multipart/form-data; boundary={boundary}"})


def http_stream(port: int, request: dict) -> dict:
    """One `POST /tts/stream`: the WAV header, the int16 PCM after it, the
    seconds to the first PCM bytes (cell 4's first-chunk latency) and to the
    end of the stream."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/tts/stream", body=json.dumps(request),
                 headers={"content-type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"POST /tts/stream {request}: HTTP {resp.status} {resp.read()!r}")
    header = resp.read(44)
    first_bytes = resp.read(2)
    first = time.perf_counter() - t0
    pcm = first_bytes + resp.read()
    total = time.perf_counter() - t0
    conn.close()
    return dict(header=header, pcm=pcm, first_s=first, total_s=total)


def thread_costs(call) -> str:
    """Wall seconds of ``call`` (ending in a device sync), twice in a row on
    the main thread, on one new thread and on an `asyncio.to_thread` worker:
    what running a request off the main thread costs the host-bound loop."""
    import asyncio

    import torch

    def timed() -> float:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {"main thread": [timed(), timed()]}
    box = []
    worker = threading.Thread(target=lambda: box.extend([timed(), timed()]))
    worker.start()
    worker.join(600)
    walls["a new thread"] = box

    async def off_loop():
        return [await asyncio.to_thread(timed), await asyncio.to_thread(timed)]

    walls["asyncio.to_thread"] = asyncio.run(off_loop())
    return "; ".join(f"{where} {a:.3f} / {b:.3f} s" for where, (a, b) in walls.items())


def phase_http(wrapper, tag: str = "[http]") -> None:
    """Benchmark cell 4 on the main phase's wrapper: the port's HTTP server on a
    free localhost port, in a thread with its own event loop; the bundled clip
    uploaded as multipart and polled until ready; three streams at NFE 32 (by
    `reference_id`, by the `speaker` alias, seeded), then two seeded streams
    one after the other and at once. Checks the chunked WAV header and int16
    PCM, the seeded stream against the wrapper's own `generate` bit for bit,
    the concurrent streams against the serial ones bit for bit, kernels 1 and 2 launched depth x NFE
    times per generated chunk (summed over the concurrent streams), and that
    the server stops with no thread or loop error left."""
    import http.client

    import numpy as np

    from eraxvif5tts_tpu_torch.serving.http_server import ServerConfig, ServerThread, TTSServer
    from eraxvif5tts_tpu_torch.serving.wave_stream import (
        create_wave_header,
        float_to_int16_bytes,
    )
    from eraxvif5tts_tpu_torch.text.chunk import chunk_text

    depth, sr = wrapper.config.arch.depth, wrapper.target_sample_rate
    threads_before = set(threading.enumerate())
    server = TTSServer(wrapper, ServerConfig(host="127.0.0.1", port=0, nfe_step=NFE,
                                             text_chunk_size=HTTP_CHUNK_CHARS))
    runner = ServerThread(server)
    loop_errors = []
    runner.loop.set_exception_handler(lambda loop, ctx: loop_errors.append(ctx))
    counting = contextlib.ExitStack()
    # one entry per generated chunk, from any worker thread
    chunks = counting.enter_context(dispatches(wrapper))
    port = runner.start()
    log(f"{tag} HTTP server on 127.0.0.1:{port}, NFE {NFE}, text chunks of "
        f"<= {HTTP_CHUNK_CHARS} chars, {server.config.max_concurrent_generations} "
        "generations at once")
    try:
        example = ROOT / "eraxvif5tts_tpu" / "infer" / "examples" / "basic"
        ref_text = tomllib.loads((example / "basic.toml").read_text())["ref_text"]
        body, headers = multipart_body({"reference_id": "clip", "ref_text": ref_text,
                                        "file": (example / "basic_ref_en.wav").read_bytes()})
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        t0 = time.perf_counter()
        conn.request("POST", "/upload_reference", body=body, headers=headers)
        resp = conn.getresponse()
        if resp.status != 202:
            raise AssertionError(f"upload: HTTP {resp.status} {resp.read()!r}")
        resp.read()
        while True:
            conn.request("GET", "/references")
            status = json.loads(conn.getresponse().read())["references"].get("clip", {})
            if status.get("status") == "ready":
                break
            if not status or time.perf_counter() - t0 > 120:
                raise AssertionError(f"uploaded reference not ready: {status}")
            time.sleep(0.05)
        conn.close()
        ref = server.references["clip"]
        log(f"{tag} upload + preprocess of the bundled clip: ready after "
            f"{time.perf_counter() - t0:.3f} s ({status['duration_seconds']} s of audio)")

        def run(requests, concurrent=False):
            reset_serving_counts()
            n0, graphs = len(chunks), graph_state(wrapper)
            out = [None] * len(requests)

            def one(i):
                out[i] = http_stream(port, requests[i])

            if concurrent:
                workers = [threading.Thread(target=one, args=(i,)) for i in range(len(requests))]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(600)
            else:
                for i in range(len(requests)):
                    one(i)
            if any(r is None for r in out):
                raise AssertionError(f"{tag} a stream did not complete")
            made = len(chunks) - n0
            steps = euler_steps(wrapper, graphs, made, NFE)[0]
            rose = serving_counts()
            want = {name: depth * steps if name in ("serving_attention", "ln_mod_matmul")
                    else 0 for name in rose}
            if rose != want:
                raise AssertionError(f"{tag} launches {rose}, expected {want} "
                                     f"({depth} x {steps} backbone steps for {made} chunks)")
            return out, made, rose

        def check(result, request, label):
            if result["header"] != create_wave_header(sr):
                raise AssertionError(f"{tag} {label}: not the streaming WAV header")
            pcm = np.frombuffer(result["pcm"], "<i2")
            if len(result["pcm"]) % 2 or not len(pcm) or np.abs(pcm).max() < 30:
                raise AssertionError(f"{tag} {label}: int16 PCM empty, odd or silent")
            audio = len(pcm) / sr
            pieces = len(chunk_text(request["text"], max_chars=HTTP_CHUNK_CHARS))
            log(f"{tag} {label}: {pieces} text piece(s), {audio:.2f} s of int16 audio; first "
                f"PCM bytes after {result['first_s']:.3f} s, stream done in "
                f"{result['total_s']:.3f} s (RTF {result['total_s'] / audio:.4f})")
            return audio

        requests = [dict(text=TEXTS[0], reference_id="clip", nfe_step=NFE),
                    dict(text=TEXTS[1], speaker="clip", nfe_step=NFE),
                    dict(text=TEXTS[2], reference_id="clip", nfe_step=NFE, seed=HTTP_SEED)]
        labels = ["stream by reference_id", "stream by the speaker alias", "seeded stream"]
        out, made, rose = run(requests)
        audio = sum(check(r, q, label) for r, q, label in zip(out, requests, labels))
        wall = sum(r["total_s"] for r in out)
        log(f"{tag} 3 streams one after another: {made} chunks, launches {rose}; "
            f"{audio:.2f} s of audio in {wall:.3f} s (RTF {wall / audio:.4f})")

        want = b"".join(float_to_int16_bytes(wrapper.generate(
            piece, ref=ref, nfe_step=NFE, seed=HTTP_SEED, return_numpy=True))
            for piece in chunk_text(TEXTS[2], max_chars=HTTP_CHUNK_CHARS))
        got = out[2]["pcm"]
        if got != want:
            a, b = (np.frombuffer(x, "<i2").astype(np.int32) for x in (got, want))
            diff = (f"{int(np.abs(a - b).max())} LSB at most" if len(a) == len(b)
                    else f"{len(a)} vs {len(b)} samples")
            raise AssertionError(f"{tag} the seeded stream differs from generate(seed="
                                 f"{HTTP_SEED}): {diff}")
        log(f"{tag} the seeded stream's PCM equals generate(seed={HTTP_SEED}) through "
            f"float_to_int16_bytes bit for bit ({len(got) // 2} samples)")
        log(f"{tag} the same generate, twice in each thread: " + thread_costs(
            lambda: wrapper.generate(TEXTS[2], ref=ref, nfe_step=NFE, seed=HTTP_SEED)))

        requests = [dict(text=TEXTS[0], reference_id="clip", nfe_step=NFE, seed=HTTP_SEED),
                    dict(text=TEXTS[2], speaker="clip", nfe_step=NFE, seed=HTTP_SEED + 1)]
        walls, pcm = {}, {}
        for mode in ("serial", "concurrent"):
            t0 = time.perf_counter()
            out, made, rose = run(requests, concurrent=mode == "concurrent")
            walls[mode] = time.perf_counter() - t0
            pcm[mode] = [r["pcm"] for r in out]
            audio = sum(check(r, q, f"{mode} stream #{i}")
                        for i, (r, q) in enumerate(zip(out, requests)))
            log(f"{tag} the 2 seeded streams, {mode}: {made} chunks, launches {rose} "
                f"(summed); {audio:.2f} s of audio in {walls[mode]:.3f} s of wall "
                f"({audio / walls[mode]:.2f} s of audio per wall s)")
        if pcm["serial"] != pcm["concurrent"]:
            raise AssertionError(f"{tag} concurrent streams differ from the same streams "
                                 "one after another")
        log(f"{tag} concurrent streams' PCM equals the serial streams' bit for bit; "
            f"concurrent / serial audio per wall s: "
            f"{walls['serial'] / walls['concurrent']:.3f}")
    finally:
        counting.close()
        runner.stop()
    left = [t.name for t in set(threading.enumerate()) - threads_before]
    if left or loop_errors:
        raise AssertionError(f"{tag} after shutdown: threads {left}, loop errors {loop_errors}")
    log(f"{tag} HTTP server shut down: no thread left, no loop error")


def save_reference_vocoder(path: Path, vocoder) -> None:
    """A reference-format Vocos checkpoint of ``vocoder`` (with the window
    buffers the published file carries)."""
    import torch

    sd = {k: v.cpu() for k, v in vocoder.state_dict().items()}
    sd["head.istft.window"] = torch.hann_window(vocoder.head.n_fft)
    sd["feature_extractor.mel_spec.spectrogram.window"] = torch.hann_window(
        vocoder.head.n_fft)
    torch.save(sd, path)


EDIT_SPAN = (1.1, 1.7)  # seconds of the bundled 3 s clip, regenerated


def phase_edit(wrapper, dev, tag: str = "[edit]") -> None:
    """Speech editing and the CLI on the card: `edit_speech` of the bundled
    clip with one span at NFE 32 (finite, the kept frames of its mel equal to
    the prompt mel pasted back, kernels 1 and 2 launched depth x NFE times),
    then `python -m eraxvif5tts_tpu_torch.infer.infer_cli` with the bundled
    basic.toml and no --device, as a subprocess, serving fp32 (the entry
    points' dtype), on a reference-format
    checkpoint and Vocos file of the main wrapper's weights and a vocab
    file; its WAV is checked."""
    import numpy as np
    import torch

    from eraxvif5tts_tpu_torch.audio.io import read_wav
    from eraxvif5tts_tpu_torch.infer.speech_edit import edit_inputs, edit_speech

    example = ROOT / "eraxvif5tts_tpu" / "infer" / "examples" / "basic"
    config = tomllib.loads((example / "basic.toml").read_text())
    audio, sr = read_wav(str(example / "basic_ref_en.wav"))
    if sr != wrapper.target_sample_rate:
        raise AssertionError(f"{tag} the bundled clip is at {sr} Hz")
    audio = audio.mean(axis=0)
    depth, hop = wrapper.config.arch.depth, wrapper.hop_length
    target = config["ref_text"].replace("one line", "two lines")
    reset_serving_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wave, mel, keep = edit_speech(wrapper, audio, config["ref_text"], target, [EDIT_SPAN],
                                  nfe_step=NFE, seed=SEED, return_mel=True)
    wall = time.perf_counter() - t0
    rose = serving_counts()
    want = {name: depth * NFE if name in ("serving_attention", "ln_mod_matmul") else 0
            for name in rose}
    if rose != want:
        raise AssertionError(f"{tag} edit_speech launches {rose}, expected {want}")
    if not (np.isfinite(wave).all() and np.isfinite(mel).all() and len(wave) > 0):
        raise AssertionError(f"{tag} edit_speech output is not finite")
    edited_wave, mask = edit_inputs(audio, [EDIT_SPAN], None, sr, hop)
    if not np.array_equal(mask, keep):
        raise AssertionError(f"{tag} edit mask differs from edit_inputs'")
    with torch.inference_mode():
        cond = wrapper.mel_spec(torch.from_numpy(edited_wave[None]).to(dev))
    cond = cond.transpose(1, 2)[0, :len(mask)].cpu().numpy()
    if not np.array_equal(mel.T[mask], cond[mask]):
        raise AssertionError(f"{tag} kept frames are not the prompt mel pasted back")
    log(f"{tag} edit_speech of {len(audio) / sr:.2f} s, span {EDIT_SPAN} s "
        f"({int((~keep).sum())} of {len(keep)} frames regenerated) at NFE {NFE}: "
        f"{wall:.3f} s; launches {rose}; kept frames equal the prompt mel")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        save_reference_checkpoint_of(tmp / "model.pt", wrapper.transformer)
        save_reference_vocoder(tmp / "vocos.pt", wrapper.vocoder)
        (tmp / "vocab.txt").write_text("\n".join(VOCAB_CHARS) + "\n", encoding="utf-8")
        written = time.perf_counter() - t0
        cmd = [sys.executable, "-m", "eraxvif5tts_tpu_torch.infer.infer_cli",
               "-c", str(example / "basic.toml"), "-p", str(tmp / "model.pt"),
               "--vocoder_ckpt", str(tmp / "vocos.pt"), "-v", str(tmp / "vocab.txt"),
               "-o", str(tmp), "-w", "cli.wav", "--seed", str(SEED)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{tag} infer_cli exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        lines = proc.stdout.strip().splitlines()
        if not any(" on cuda" in line and "(float32)" in line for line in lines):
            raise AssertionError(f"{tag} infer_cli did not serve fp32 on the card: {lines}")
        cli_wave, cli_sr = read_wav(str(tmp / "cli.wav"))
        if not (cli_sr == sr and cli_wave.shape[1] > sr and np.isfinite(cli_wave).all()
                and np.abs(cli_wave).max() > 1e-3):
            raise AssertionError(f"{tag} infer_cli's WAV is empty, short or silent")
    log(f"{tag} checkpoint + vocoder + vocab written in {written:.1f} s; `python -m "
        f"eraxvif5tts_tpu_torch.infer.infer_cli -c basic.toml` (no --device) said "
        f"{lines[0]!r} (fp32 on the card, through utils_infer.compute_dtype_for) and wrote "
        f"{cli_wave.shape[1] / cli_sr:.2f} s of audio in "
        f"{cli_wall:.1f} s of process wall (start-up and checkpoint load included)")


def save_reference_checkpoint_of(path: Path, backbone) -> None:
    """A reference-format checkpoint (EMA keys, fp32) of ``backbone``'s weights."""
    import torch

    torch.save({f"ema_model.transformer.{k}": (v.float() if v.is_floating_point() else v).cpu()
                for k, v in backbone.state_dict().items()}, path)


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
    from eraxvif5tts_tpu_torch.models import build_backbone

    backbone = build_backbone(cfg, len(VOCAB_CHARS)).to(dev)
    randomize((backbone,), SEED + 3)
    save_reference_checkpoint_of(path, backbone)


def with_int8_ff(flag: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ERAX_INT8_FF set to 1 or unset."""
    if flag:
        os.environ["ERAX_INT8_FF"] = "1"
    else:
        os.environ.pop("ERAX_INT8_FF", None)
    try:
        return fn(*args, **kwargs)
    finally:
        os.environ.pop("ERAX_INT8_FF", None)


def run_batch(wrapper, depth: int, nfe: int, seed: int, int8_ff: bool, label: str,
              tag: str = "[int8]", ffs: int | None = None):
    """One `generate_batch` of BATCH_TEXTS, ERAX_INT8_FF set or unset, with
    its launch counters checked for each backbone step the card ran (NFE in
    the batch's graph replay, one in the eager run before its capture when
    the key is new; ERAX_INT8_FF is part of the key): kernel 1 depth, kernel
    5 ``ffs`` (the feed-forwards of a backbone call, default depth) with the
    one-kernel feed-forward and none without, kernel 2 none on the int8 path
    (quantized blocks take the unfused FF) and none in an MMDiT.
    Returns (waves, wall s, seconds of audio)."""
    import numpy as np
    import torch

    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.ops import quant_ff as qf
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa

    fused_ff = wrapper.compute_dtype != "int8" and wrapper.config.backbone != "MMDiT"
    counters = (sa.serving_attention, qf.int8_ff, fm.ln_mod_matmul)
    before, graphs = [fn.launches for fn in counters], graph_state(wrapper)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    waves = with_int8_ff(int8_ff, wrapper.generate_batch, list(BATCH_TEXTS), nfe_step=nfe,
                         seed=seed)
    wall = time.perf_counter() - t0
    counts = [fn.launches - c for fn, c in zip(counters, before)]
    steps, captured = euler_steps(wrapper, graphs, 1, nfe)
    audio = sum(len(w) for w in waves) / wrapper.target_sample_rate
    want = [steps * n for n in (depth, (ffs or depth) if int8_ff else 0,
                                depth if fused_ff else 0)]
    log(f"{tag} generate_batch {label} ({len(waves)} texts, NFE {nfe}): {audio:.2f} s of "
        f"audio in {wall:.3f} s ({audio / wall:.2f} s of audio per wall s, "
        f"{'graph captured and replayed' if captured else 'one graph replay'}); launches "
        f"attention / int8_ff / ln_mod {counts}")
    if counts != want:
        raise AssertionError(f"generate_batch {label}: launches {counts}, expected {want}")
    if len(waves) != len(BATCH_TEXTS) or not all(
            len(w) > 0 and np.isfinite(w).all() and np.abs(w).max() > 1e-3 for w in waves):
        raise AssertionError(f"generate_batch {label}: PCM is not finite and non-silent")
    return waves, wall, audio


def phase_int8(dev, cfg, tag: str = "[int8]", ckpt: Path | None = None,
               turns: int = 2) -> tuple[int, float]:
    """int8 W8A8 serving of ``cfg``'s backbone (DiT, UNetT or MMDiT) from a
    reference-format checkpoint (``ckpt``, or one written here): the quality
    gate's reading, warm-up batches that record the shapes kernel 5 is given
    (the MMDiT's two streams give it two) and capture each run's graph, the
    [dispatch] checks with the fused feed-forward (``[int8]`` only), the quantized backbone and kernel
    5 against their plain versions at those shapes, then ``turns`` rounds of
    `generate_batch` bf16 / int8 chain / int8 fused (the second in the
    reverse order) and, with two, profiled batches. Returns the int8
    feed-forward's launches in the measured batch calls and its largest
    error against the plain version at the shapes the backbone gives it."""
    import numpy as np
    import torch

    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.models import modules
    from eraxvif5tts_tpu_torch.ops import quant_ff as qf
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa

    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    a = cfg.arch
    unett, mmdit = cfg.backbone == "UNetT", cfg.backbone == "MMDiT"
    ffs = 2 * a.depth - 1 if mmdit else a.depth  # the last MMDiT block has no ff_c
    with tempfile.TemporaryDirectory() as tmp:
        if ckpt is None:
            ckpt = Path(tmp) / "model.pt"
            t0 = time.perf_counter()
            save_reference_checkpoint(ckpt, cfg, dev)
            log(f"{tag} reference-format checkpoint of N(0, {WEIGHT_STD}) weights, seed "
                f"{SEED + 3}: {ckpt.stat().st_size / 2**30:.2f} GiB written in "
                f"{time.perf_counter() - t0:.1f} s")
        common = dict(model_cfg=cfg, ckpt_path=str(ckpt), vocab_char_map=vocab, device=dev,
                      nfe_step=NFE)
        t0 = time.perf_counter()
        int8 = F5TTSWrapper(compute_dtype="int8", int8_validate=True, **common)
        torch.cuda.synchronize()
        report = int8.int8_report
        log(f"{tag} {cfg.name} F5TTSWrapper(compute_dtype='int8', int8_validate=True) built in "
            f"{time.perf_counter() - t0:.1f} s; quality gate (8 steps, max_duration "
            f"{255 if unett else 256}, against a bf16 twin): rel_mse {report['rel_mse']:.4g}, "
            f"lsd_db {report['lsd_db']:.4g}, forward_rel_mse {report['forward_rel_mse']:.4g}, "
            f"passes {report['passes_gate']}")
        bf16 = F5TTSWrapper(compute_dtype="bfloat16", **common)
    # the vocoders: the same seeded draw as the main phase's
    randomize((int8.vocoder,), SEED)
    randomize((bf16.vocoder,), SEED)
    q_names = [name for name, _ in int8.transformer.named_buffers() if name.endswith("weight_q")]
    q_bytes = sum(b.numel() for name, b in int8.transformer.named_buffers() if name in q_names)
    log(f"{tag} {a.depth} quantized {'layers' if unett else 'blocks'} (dim {a.dim}, "
        f"depth {a.depth}, ff_mult {a.ff_mult}): {q_bytes / 2**20:.1f} MiB of int8 weights "
        f"({len(q_names)} projections{', 12 a block and 9 in the last' if mmdit else ''}), "
        f"the rest bf16 matrices{' (skip projections included)' if unett else ''} "
        "and fp32 vectors")
    ref = load_reference(int8)
    load_reference(bf16)
    runs = {"bf16": (bf16, False), "int8 chain": (int8, False), "int8 fused": (int8, True)}
    shapes = set()  # the [rows, positions] the batch gives kernel 5 (with CFG)
    ff = modules.int8_ff

    def recorded(x, *args, **kwargs):
        shapes.add(tuple(x.shape[:2]))
        return ff(x, *args, **kwargs)

    modules.int8_ff = recorded
    try:
        # warm-up: each run's graph captured at the measured calls' key
        for label, (wrapper, int8_ff) in runs.items():
            run_batch(wrapper, a.depth, NFE, SEED, int8_ff, f"{label} warm-up", tag, ffs)
    finally:
        modules.int8_ff = ff
    # the mel stream's rows (the MMDiT's text stream gives the text bucket's)
    (b, n), *text_rows = sorted(shapes, key=lambda shape: -shape[1])
    frames = n - 1 if unett else n  # the UNetT's time token is a position of its own
    text = {"text_len": text_rows[0][1]} if mmdit else {}
    log(f"{tag} the batch of {len(BATCH_TEXTS)} texts runs the {type(int8.transformer).__name__} "
        f"at {b} rows x {n} positions" + (f" (mel) and {text['text_len']} (text)" if mmdit else ""))
    if tag == "[int8]":
        timed(f"{tag} [dispatch]", with_int8_ff, True, check_dispatch, int8, ref, tag,
              {"serving_attention": a.depth, "int8_ff": ffs})
    cases = ((2, 767), (b, frames)) if unett else ((b, frames),)
    for int8_ff in (False, True):
        for rows, length in cases:
            with_int8_ff(int8_ff, check_dit_against_plain, int8.transformer, dev,
                         f"{tag} ERAX_INT8_FF={'1' if int8_ff else 'unset'}:", rows, length, **text)
    k, n_hidden = a.dim, int(a.dim * a.ff_mult)
    ff_err = max(check_int8_ff_shape(dev, torch.Generator(device=dev).manual_seed(SEED + 5),
                                     rows, length, tag, k=k, n=n_hidden)[0]
                 for rows, length in ((b, n), *text_rows))
    if unett:
        # batch 1 at NFE 32: kernel 5 depth x NFE a chunk with the flag, none without
        warm_smallest(int8, ref)
        with_int8_ff(False, generate_counted, int8, ref, TEXTS[:1], NFE,
                     f"{tag} ERAX_INT8_FF=unset:", ("serving_attention_norope",))
        with_int8_ff(True, generate_counted, int8, ref, TEXTS[:1], NFE,
                     f"{tag} ERAX_INT8_FF=1:", ("serving_attention_norope", "int8_ff"))
    sa.serving_attention.launches = qf.int8_ff.launches = 0
    waves, walls, audio = {}, {label: [] for label in runs}, {}
    for label in (*runs, *reversed(runs))[:3 * turns]:
        wrapper, int8_ff = runs[label]
        waves[label], wall, audio[label] = run_batch(wrapper, a.depth, NFE, SEED + 4, int8_ff,
                                                     label, tag, ffs)
        walls[label].append(wall)
    launches = qf.int8_ff.launches
    diffs = [float(np.abs(x - y).max()) for x, y in zip(waves["int8 chain"], waves["int8 fused"])]
    rel = [float(np.linalg.norm(x - y) / np.linalg.norm(y))
           for x, y in zip(waves["int8 chain"], waves["int8 fused"])]
    log(f"{tag} int8 chain vs fused, same seed, per text: max |difference| "
        f"{max(diffs):.4g} of full scale, relative L2 {min(rel):.3g}-{max(rel):.3g} (the fused "
        f"feed-forward keeps the hidden state in fp32; the chain rounds it to bf16)")
    rates = {label: audio[label] / statistics.mean(w) for label, w in walls.items()}
    log(f"{tag} throughput, seconds of audio per wall second (mean of {turns} call(s) in turns "
        f"bf16, chain, fused{', fused, chain, bf16' if turns > 1 else ''}; batch "
        f"{len(BATCH_TEXTS)}, NFE {NFE}): "
        + ", ".join(f"{label} {rate:.3f}" for label, rate in rates.items())
        + f"; int8 chain / bf16 {rates['int8 chain'] / rates['bf16']:.3f}, int8 fused / bf16 "
        f"{rates['int8 fused'] / rates['bf16']:.3f}")
    if turns > 1:
        if not unett:
            profile_generate(bf16, None, BATCH_TEXTS, NFE, f"{tag} bf16")
        with_int8_ff(True, profile_generate, int8, None, BATCH_TEXTS, NFE, f"{tag} int8 fused")
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


def loss_batch(dev, seed: int, depth: int, frac_lengths_mask=(0.7, 1.0), n: int = 1024):
    """The loss checks' batch, b = 2, n frames (the second sample 37 frames
    short, its text 300 tokens), and its draws for ``depth`` blocks."""
    import torch

    from eraxvif5tts_tpu_torch.models.cfm import LossDraws

    g = torch.Generator(device=dev).manual_seed(seed)
    b = 2
    mel = torch.randn((b, n, 100), generator=g, device=dev)
    lens = torch.tensor([n, n - 37], device=dev)
    text = torch.randint(0, len(VOCAB_CHARS), (b, TRAIN_TEXT), generator=g, device=dev)
    text[1, 300:] = -1
    return mel, text, lens, LossDraws.sample(g, b, n, 100, depth, frac_lengths_mask)


def hold_loss_against_plain(what: str, model, loss_fn, draws, tols: dict,
                            control: str = "keys", rounding: tuple = ()):
    """``loss_fn(draws)`` (a loss of ``model``) forward and backward with the
    training kernels against the plain attention, on the same draws and
    dropout keys. Three readings are logged: the loss, the whole flattened
    gradient and the gradient of the q / k / v projections (which reaches the
    parameters only through the attention backward); each one named in
    ``tols`` is held within its limit there. The control is the plain
    attention with the attention-dropout keys of every block changed
    (``control="keys"``) or, where there is no dropout, with the last 64-key
    tile of every sample masked (``"tile"``, :func:`lost_tile_attention`);
    it must move each held reading beyond its limit, or that limit could not
    see wrong masks, except the readings named in ``rounding``, which are
    held within bf16 rounding alone (the control moves them no further)."""
    import torch

    from eraxvif5tts_tpu_torch.ops.train_attention import train_attention

    wrong = dataclasses.replace(draws, dropout_keys=[
        [[(attn[0] + 1) & 0xFFFFFFFF, attn[1]], out, ff]
        for attn, out, ff in draws.dropout_keys])
    qkv = [p for name, p in model.named_parameters()
           if name.split(".")[-2] in ("to_q", "to_k", "to_v")]

    def loss_and_grads(draws, plain):
        model.zero_grad(set_to_none=True)
        train_attention.plain = plain
        try:
            loss = loss_fn(draws)
            loss.backward()
        finally:
            train_attention.plain = False
        return (loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()]),
                torch.cat([p.grad.flatten() for p in qkv]))

    got = loss_and_grads(draws, plain=False)
    want = loss_and_grads(draws, plain=True)
    if control == "keys":
        control = loss_and_grads(wrong, plain=True)
        about = "plain, wrong attention-dropout keys"
    else:
        with lost_tile_attention():
            control = loss_and_grads(draws, plain=True)
        about = "plain, the last 64-key tile masked"
    model.zero_grad(set_to_none=True)

    def distance(x):
        return dict(zip(("loss", "gradient L2", "q/k/v gradient L2"),
                        (abs(x[0] - want[0]) / abs(want[0]), rel_l2(x[1], want[1]),
                         rel_l2(x[2], want[2]))))

    err, ctl = distance(got), distance(control)
    log(f"{what}, kernels vs plain attention: loss {got[0]:.6f} vs {want[0]:.6f}; relative "
        f"errors (tol, or logged where none) / control ({about}): "
        + ", ".join(f"{name} {e:.3g} ({tols.get(name, 'logged')}) / {ctl[name]:.3g}"
                    for name, e in err.items()))
    if not (all(err[name] <= t for name, t in tols.items()) and torch.isfinite(got[1]).all()):
        raise AssertionError(f"{what} with kernels differs from plain: {err}")
    if not all(ctl[name] > t for name, t in tols.items() if name not in rounding):
        raise AssertionError(f"the control ({about}) moves the plain readings by only "
                             f"{ctl}, not beyond the limits {tols}")


def check_loss_against_plain(cfm, dev):
    """One CFM.loss at b = 2, n = 1024 with the training kernels against the
    plain attention (:func:`hold_loss_against_plain`), every reading
    controlled."""
    dit = cfm.transformer
    mel, text, lens, draws = loss_batch(dev, SEED + 2, len(dit.transformer_blocks))
    hold_loss_against_plain(f"[train] CFM.loss b=2 n=1024 dropout {dit.arch.dropout}", dit,
                            lambda draws: cfm.loss(mel, text, lens, draws)[0], draws,
                            {"loss": LOSS_TOL, "gradient L2": GRAD_TOL,
                             "q/k/v gradient L2": QKV_GRAD_TOL})


def profile_train_step(trainer, state, batch, dev, wall_s: float,
                       tag: str = "[train]") -> None:
    """Where one warm `train_step` at the model's dropout (of a `Trainer` or a
    `DistillTrainer`) spends the device's time: its
    kernels under `torch.profiler`, summed by group, beside `wall_s` (the
    unprofiled steps' wall at dropout 0.1). The position-hash dropout is plain
    torch: its share is the device time of the kernels launched inside
    `hash_dropout` (forward and checkpoint recompute; its backward is one
    `where` pass per call and stays under "other"), and the time of one call
    at each of the two shapes a block gives it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from eraxvif5tts_tpu_torch.models import modules
    from eraxvif5tts_tpu_torch.training.trainer import batch_seed

    plain_dropout = modules.hash_dropout

    def marked_dropout(*args, **kwargs):
        with record_function("hash_dropout"):
            return plain_dropout(*args, **kwargs)

    modules.hash_dropout = marked_dropout
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train_step(state, batch,
                               torch.Generator(device=dev).manual_seed(batch_seed(SEED, 0, 4)))
            torch.cuda.synchronize()
    finally:
        modules.hash_dropout = plain_dropout
    groups, launches = device_ms_by_group(prof, ranges=("hash_dropout",))
    device_ms = sum(groups.values())
    if device_ms <= 0.0:
        log(f"{tag} profile: the profiler recorded no device time; split not measured")
        return
    # the range's host-side events carry the time of the kernels launched inside
    marked = [e for e in prof.key_averages()
              if e.key == "hash_dropout" and e.device_type == torch.autograd.DeviceType.CPU]
    dropout_ms = sum(e.device_time_total for e in marked) / 1e3
    calls = sum(e.count for e in marked)
    b, n = batch["mel"].shape[:2]
    dim = state.model.arch.dim
    ff = dim * state.model.arch.ff_mult
    one = {}
    for width in (dim, ff):
        x = torch.randn((b, n, width), device=dev).to(state.model.dtype)
        one[width] = cuda_median_ms(lambda: plain_dropout(x, 0.1, (1, 2)))
    attention_ms = sum(ms for name, ms in groups.items() if name.startswith("kernel 4"))
    log(f"{tag} profile of one warm train_step at dropout {state.model.arch.dropout}: wall "
        f"{wall_s * 1e3:.1f} ms "
        f"unprofiled; {launches} device kernels, {device_ms:.1f} ms of device time = "
        f"{100 * device_ms / (wall_s * 1e3):.1f} % of the wall; "
        + ", ".join(f"{name} {ms:.1f} ms ({100 * ms / device_ms:.1f} %)"
                    for name, ms in groups.items())
        + f"; kernel 4 together {attention_ms:.1f} ms ({100 * attention_ms / device_ms:.1f} %); "
        f"of the other kernels, {dropout_ms:.1f} ms ({100 * dropout_ms / device_ms:.1f} %) ran "
        f"inside {calls} hash_dropout calls (one call alone: "
        + ", ".join(f"[{b}, {n}, {width}] {ms:.3f} ms" for width, ms in one.items()) + ")")


def train_batch(dev, seed: int, shape: tuple[int, int] | None = None,
                text_len: int = TRAIN_TEXT) -> dict:
    """A training batch of ``shape`` (default TRAIN_BATCH) from ``seed``:
    random mels, lengths from n / 2 to n, text padded to ``text_len`` tokens
    with -1 past a random length."""
    import torch

    b, n = shape or TRAIN_BATCH
    bg = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(n // 2, n + 1, (b,), generator=bg, device=dev)
    text = torch.randint(0, len(VOCAB_CHARS), (b, text_len), generator=bg, device=dev)
    text_lens = torch.randint(text_len // 4, text_len + 1, (b, 1), generator=bg, device=dev)
    text = text.masked_fill(torch.arange(text_len, device=dev) >= text_lens, -1)
    return {"mel": torch.randn((b, n, 100), generator=bg, device=dev), "text": text,
            "lens": lens}


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

    def make_batch(i):
        return train_batch(dev, SEED + 10 + i)

    for i, rate in enumerate((0.1, 0.1, 0.1, 0.0)):
        dit.arch = dataclasses.replace(dit.arch, dropout=rate)
        batch = make_batch(i)
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
    dit.arch = dataclasses.replace(dit.arch, dropout=0.1)
    profile_train_step(trainer, state, make_batch(4), dev, statistics.median(walls[1:3]))
    return launches


def phase_e2tts(dev, cfg=None, ckpt: Path | None = None) -> dict:
    """E2-TTS zero-shot cloning at full E2TTS_Base width and depth (``cfg``:
    another UNetT configuration, for a rehearsal) from a reference-format
    checkpoint written to ``ckpt`` (kept for the e2tts-int8 phase) or to a
    temporary file. Returns the launches of the attention kernel without
    fused rotary and of the projection kernel in RMS mode over the three
    requests."""
    import torch

    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.models.unett import UNetT

    cfg = cfg or PRESETS["E2TTS_Base"]
    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = ckpt or Path(tmp) / "model.pt"
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
    warmed = warm_smallest(wrapper, ref)
    log(f"[e2tts] reference {ref.n_frames} frames; warmup (one NFE-{NFE} step at the smallest "
        f"(duration, text) buckets {warmed}) {time.perf_counter() - t0:.2f} s: "
        f"{graphs_logged(wrapper)}")
    path = ("serving_attention_norope", "ln_mod_matmul_rms")
    timed("[e2tts] [dispatch]", check_dispatch, wrapper, ref, "[e2tts]",
          {name: a.depth for name in path})
    counts = generate_counted(wrapper, ref, TEXTS, NFE, "[e2tts]", path)
    profile_generate(wrapper, ref, TEXTS[1], NFE, "[e2tts]")
    phase_server(wrapper, ref, TEXTS[:1], "[e2tts]")
    return {name: counts[name] for name in path}


BIGVGAN_TOL = 1e-4  # |card - CPU| of BigVGAN's fp32 wave, in units of its scale
BIGVGAN_MEL_FRAMES = 128  # the mel the card-versus-CPU check vocodes


def vocode_timed(wrapper):
    """Make ``wrapper.vocoder`` record each call's wall (synchronised before
    and after, so it is the vocoder's alone); returns the list it fills and
    a function that undoes it."""
    import torch

    vocoder, times = wrapper.vocoder, []
    forward = vocoder.forward

    def timed(mel):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(mel)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    vocoder.forward = timed
    return times, lambda: vars(vocoder).pop("forward")


def check_bigvgan_against_cpu(wrapper, dev, mel) -> float:
    """The card's BigVGAN on ``mel [1, 100, frames]`` against the same module
    on the CPU, both fp32 (TF32 off on the card): the error in units of the
    CPU wave's scale, held to BIGVGAN_TOL. A control runs the card's
    convolutions with TF32 on and logs its distance (not held: it shows
    what the limit can see)."""
    import copy

    import torch

    from eraxvif5tts_tpu_torch.models import bigvgan

    cpu = copy.deepcopy(wrapper.vocoder).cpu()
    with torch.inference_mode():
        got = wrapper.vocoder(mel.to(dev)).cpu()
        t0 = time.perf_counter()
        want = cpu(mel.cpu())
        cpu_s = time.perf_counter() - t0
        del cpu

        @contextlib.contextmanager
        def tf32_on():
            saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            try:
                yield
            finally:
                torch.backends.cudnn.allow_tf32 = saved

        switch = bigvgan.fp32_convolutions
        bigvgan.fp32_convolutions = tf32_on
        try:
            control = wrapper.vocoder(mel.to(dev)).cpu()
        finally:
            bigvgan.fp32_convolutions = switch
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / max(scale, 1e-6)
    control_err = float((control - want).abs().max()) / max(scale, 1e-6)
    log(f"[bigvgan] BigVGAN on {mel.shape[-1]} mel frames ({got.shape[-1]} samples), card vs "
        f"CPU fp32: max error {err:.3g} of scale {scale:.3g} (tol {BIGVGAN_TOL}); control "
        f"with TF32 on for the card's convolutions: {control_err:.3g}; CPU wall {cpu_s:.2f} s")
    if not (torch.isfinite(got).all() and err <= BIGVGAN_TOL and scale > 1e-3):
        raise AssertionError(f"[bigvgan] the card's BigVGAN differs from the CPU's by {err:.3g}"
                             f" of scale {scale:.3g}")
    return err


def phase_bigvgan(main_wrapper, dev) -> dict:
    """F5TTS_v1_Base with BigVGAN: a reference-format checkpoint of the main
    phase's weights served by `F5TTSWrapper("F5TTS_v1_Base",
    vocoder_name="bigvgan")` with the full `bigvgan_v2_24khz_100band_256x`
    generator (1536 initial channels, the JAX wrapper's random draw), bf16
    backbone and fp32 vocoder: three `generate`s at NFE 32 with kernels 1
    (rotary) and 2 counted per chunk, BigVGAN's share of one `generate`,
    the card's BigVGAN against the CPU's on a generated mel, and cuDNN's TF32
    flag the same after the phase as before it. Returns the launches."""
    import torch

    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.models.bigvgan import BigVGAN

    tf32_before = torch.backends.cudnn.allow_tf32
    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "model.pt"
        t0 = time.perf_counter()
        save_reference_checkpoint_of(ckpt, main_wrapper.transformer)
        written = time.perf_counter() - t0
        t0 = time.perf_counter()
        wrapper = F5TTSWrapper("F5TTS_v1_Base", ckpt_path=str(ckpt), vocab_char_map=vocab,
                               vocoder_name="bigvgan", device=dev, compute_dtype="bfloat16",
                               nfe_step=NFE)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
    vocoder = wrapper.vocoder
    if not isinstance(vocoder, BigVGAN) or wrapper.mel_spec.mel_spec_type != "bigvgan":
        raise AssertionError("[bigvgan] the wrapper did not take BigVGAN and its frontend")
    served = wrapper.transformer.state_dict()
    for key, value in main_wrapper.transformer.state_dict().items():
        if not torch.equal(served[key], value):
            raise AssertionError(f"[bigvgan] {key} differs from the main phase's weights")
    c = vocoder.config
    n_params = sum(p.numel() for p in vocoder.parameters())
    log(f"[bigvgan] main phase's DiT written as a reference checkpoint in {written:.1f} s; "
        f"wrapper built in {built:.1f} s: BigVGAN {c.upsample_initial_channel} initial "
        f"channels, upsampling {c.upsample_rates}, {c.activation}, {n_params / 1e6:.1f} M "
        f"params fp32 (the JAX wrapper's random draw), mel frontend bigvgan; DiT bf16, "
        f"equal to the main phase's")
    ref = load_reference(wrapper)
    t0 = time.perf_counter()
    warmed = warm_smallest(wrapper, ref)
    log(f"[bigvgan] reference {ref.n_frames} frames; warmup {warmed} "
        f"{time.perf_counter() - t0:.2f} s: {graphs_logged(wrapper)}")
    path = ("serving_attention", "ln_mod_matmul")
    depth = wrapper.config.arch.depth
    timed("[bigvgan] [dispatch]", check_dispatch, wrapper, ref, "[bigvgan]",
          {name: depth for name in path})
    counts = generate_counted(wrapper, ref, TEXTS, NFE, "[bigvgan]", path)
    # the vocoder's share with the eager step in place of the graph: a replay
    # runs no Python, so only the eager step's vocoder calls can be timed
    wrapper._dispatch_sample_vocode = wrapper._sample_vocode
    times, undo = vocode_timed(wrapper)
    try:
        t0 = time.perf_counter()
        wave, mel = wrapper.generate(TEXTS[1], seed=SEED, nfe_step=NFE, return_spectrogram=True)
        wall = time.perf_counter() - t0
    finally:
        undo()
        del wrapper._dispatch_sample_vocode
    audio = len(wave) / wrapper.target_sample_rate
    if not times:
        raise AssertionError("[bigvgan] the eager generate made no vocoder call")
    log(f"[bigvgan] one generate of {audio:.2f} s of audio through the eager step: wall "
        f"{wall:.3f} s (RTF {wall / audio:.4f}, vocoder calls synchronised), BigVGAN "
        f"{sum(times):.3f} s over {len(times)} call(s) = {100 * sum(times) / wall:.1f} % of it")
    mel = torch.from_numpy(mel[None, :, :BIGVGAN_MEL_FRAMES].copy())
    check_bigvgan_against_cpu(wrapper, dev, mel)
    if torch.backends.cudnn.allow_tf32 != tf32_before:
        raise AssertionError("[bigvgan] cudnn.allow_tf32 changed over the phase")
    log(f"[bigvgan] cudnn.allow_tf32 {tf32_before} before the phase and after it")
    return {name: counts[name] for name in path}


def phase_mmdit(dev, cfg=None, ckpt: Path | None = None) -> int:
    """An MMDiT of ``cfg`` (default F5TTS_v1_MMDiT: dim 1024, 22 blocks, 16
    x 64 heads, ff_mult 2; the smoke cuts its depth) in bf16 from a seeded
    N(0, 0.02) reference-format checkpoint loaded strict: the MMDiT with its
    kernels against the plain versions at b = 2, n = 256 with text 128, then
    once through the backbone at the longest joint sequence (text bucket 2048
    + mel bucket 4096 = 6144, depth launches of kernel 1 without rotary
    counted), then three `generate`s at NFE 32 with kernel 1 without rotary
    counted depth x 32 a chunk and kernel 2 at 0, and a profiled request.
    ``ckpt``:
    where to write the checkpoint (kept for the fp32 phase), else a
    temporary file. Returns kernel 1's launches over the three requests."""
    import torch

    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.infer.utils import DURATION_BUCKETS, TEXT_BUCKETS
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.models.mmdit import MMDiT

    cfg = cfg or PRESETS["F5TTS_v1_MMDiT"]
    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = ckpt or Path(tmp) / "mmdit.pt"
        t0 = time.perf_counter()
        save_reference_checkpoint(ckpt, cfg, dev)
        log(f"[mmdit] reference-format checkpoint of N(0, {WEIGHT_STD}) weights, seed "
            f"{SEED + 3}: {ckpt.stat().st_size / 2**30:.2f} GiB written in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        wrapper = F5TTSWrapper(model_cfg=cfg, ckpt_path=str(ckpt), vocab_char_map=vocab,
                               device=dev, compute_dtype="bfloat16", nfe_step=NFE)
        torch.cuda.synchronize()
    net = wrapper.transformer
    if not isinstance(net, MMDiT):
        raise AssertionError(f"[mmdit] the phase built a {type(net).__name__}, not an MMDiT")
    randomize((wrapper.vocoder,), SEED)  # the same seeded draw as the main phase's
    a = wrapper.config.arch
    n_params = sum(p.numel() for p in net.parameters())
    log(f"[mmdit] {cfg.name} MMDiT dim {a.dim} depth {a.depth} heads {a.heads}x{a.dim_head} "
        f"ff_mult {a.ff_mult} qk_norm {a.qk_norm}: {n_params / 1e6:.1f} M params, bf16, loaded "
        f"strict from the checkpoint in {time.perf_counter() - t0:.1f} s")
    check_dit_against_plain(net, dev, "[mmdit]", 2, 256, text_len=128)
    nt, n = TEXT_BUCKETS[-1], DURATION_BUCKETS[-1]
    reset_serving_counts()
    t0 = time.perf_counter()
    check_dit_against_plain(net, dev, "[mmdit] longest joint sequence:", 2, n, text_len=nt)
    rose = serving_counts()
    want = {name: a.depth if name == "serving_attention_norope" else 0 for name in rose}
    if rose != want:
        raise AssertionError(f"[mmdit] joint n = {nt + n}: launches {rose}, expected {want}")
    log(f"[mmdit] joint n = {nt} + {n} = {nt + n} through the backbone at b = 2: launches "
        f"{rose} ({time.perf_counter() - t0:.1f} s with the plain pass)")
    ref = load_reference(wrapper)
    t0 = time.perf_counter()
    warmed = warm_smallest(wrapper, ref)
    log(f"[mmdit] reference {ref.n_frames} frames; warmup {warmed} "
        f"{time.perf_counter() - t0:.2f} s: {graphs_logged(wrapper)}")
    path = ("serving_attention_norope",)
    timed("[mmdit] [dispatch]", check_dispatch, wrapper, ref, "[mmdit]",
          {"serving_attention_norope": a.depth})
    counts = generate_counted(wrapper, ref, TEXTS, NFE, "[mmdit]", path)
    profile_generate(wrapper, ref, TEXTS[1], NFE, "[mmdit]")
    return counts["serving_attention_norope"]


# fp32 serving (the JAX package's default dtype)
FP32_TOL = 2e-5  # kernel 1 fp32 vs plain, |err| <= FP32_TOL * (1 + |plain|): fp32 sums
# over at most 6144 keys taken in another order
FP32_CASES = ((1088, (1051, 0)), (JOINT_N, JOINT_LENS))  # (n, lens): the DiT's, the MMDiT's top
FP32_BACKBONE_TOL = 1e-4  # a full-width fp32 DiT call, card vs CPU, in units of its scale
FP32_BACKBONE_N = 256


@contextlib.contextmanager
def tf32(on: bool):
    """Both process-wide TF32 flags (cuBLAS matmuls, cuDNN convolutions) set
    to ``on`` inside the block, back to their values after it."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp32_backward_stated(bwd: dict) -> dict:
    """`backward_geometry_fp32`'s constants under the names the built
    kernels report them (`kernel_geometry_fp32`)."""
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    return {key: bwd["rows" if key == "bwd_rows" else key] for key in ta.FP32_BACKWARD_BUILT}


def check_fp32_forward_geometry() -> None:
    """The constants the built fp32 forwards report (kernel 1's fp32 mode and
    kernel 4a's, one core) against `forward_geometry_fp32`'s, and the
    backward's against `backward_geometry_fp32`'s: one line, or an error."""
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    fwd, bwd = ta.forward_geometry_fp32(2, 4096, 16), ta.backward_geometry_fp32(2, 4096, 16)
    stated = {key: fwd[key] for key in ta.FP32_FORWARD_BUILT}
    train_built, serve_built = ta.kernel_geometry_fp32(), sa.kernel_geometry_fp32()
    want_train = dict(stated, **fp32_backward_stated(bwd))
    if serve_built != stated or train_built != want_train:
        raise AssertionError(f"[fp32] built fp32 geometry kernel 1 {serve_built}, kernel 4 "
                             f"{train_built}; stated {stated}, {want_train}")
    log(f"[fp32] built geometry of the fp32 forward core (kernel 1 fp32 and 4a fp32 alike) "
        f"equals the stated one: {stated}, {fwd['blocks_per_sm']} blocks an SM; the "
        f"backward's {want_train['dq_threads']} threads, {want_train['bwd_stages']} stages, "
        f"{want_train['dq_shared_bytes']} / {want_train['dkv_shared_bytes']} bytes")


def check_serving_attention_fp32(dev) -> dict:
    """Kernel 1 on fp32 q, k, v (`csrc/serving_attention_fp32.cu`) against its
    plain version with TF32 off, with and without rotary, at n = 1088 (lens
    1051 and 0, the DiT's serving shape) and n = 6144 (lens 6144 and
    2048 + 1051, the MMDiT's longest joint sequence): within FP32_TOL, a
    second call bit-identical. At n = 1088 the plain version on the card is
    held to the same version on the CPU, and at both shapes a control runs
    the plain version with TF32 on, which the check must refuse, and the
    kernel runs again with both TF32 flags on and must give the same bits.
    Times of the kernel, the plain version and, without rotary, fp32
    `scaled_dot_product_attention` on the same q, k, v and key mask; the
    bound at the 3xTF32 rate (the kernel's products), the FFMA rate's
    beside. First, the built geometry of both fp32 forwards against the
    stated one (:func:`check_fp32_forward_geometry`). Returns the JSON rows
    (n = 1088)."""
    import torch
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    check_fp32_forward_geometry()
    gen = torch.Generator(device=dev).manual_seed(SEED + 120)
    rows = {}
    for n, lens_list in FP32_CASES:
        q, k, v = (torch.randn((2, n, 16, 64), generator=gen, device=dev) for _ in range(3))
        lens = torch.tensor(lens_list, device=dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        key_mask = (torch.arange(n, device=dev)[None] < lens[:, None])[:, None, None, :]
        for with_rope in (True, False):
            name = "serving_attention_fp32" + ("" if with_rope else "_norope")
            case = f"{name} n={n} lens={list(lens_list)}"
            rope = rotary_freqs(n, 64, device=dev) if with_rope else None
            with tf32(False):
                want = sa.serving_attention_reference(q, k, v, lens, rope)
                plain_ms = cuda_median_ms(
                    lambda: sa.serving_attention_reference(q, k, v, lens, rope),
                    iters=5, warmup=1)
            got = sa.serving_attention(q, k, v, lens, rope)
            err = compare(case, got, want, FP32_TOL)
            if not torch.equal(got, sa.serving_attention(q, k, v, lens, rope)):
                raise AssertionError(f"{case}: a second call on the same inputs differs")
            with tf32(True):  # the kernel's precision is its own
                flagged = sa.serving_attention(q, k, v, lens, rope)
                control = sa.serving_attention_reference(q, k, v, lens, rope)
            if not torch.equal(got, flagged):
                raise AssertionError(f"{case}: the kernel's result moves with the TF32 flags")
            del flagged
            control_err = float(((control - want).abs() / (1 + want.abs())).max())
            del control
            if control_err <= FP32_TOL:
                raise AssertionError(f"{case}: the TF32 control ({control_err:.3g}) passes the "
                                     f"{FP32_TOL} check: it cannot see TF32")
            cpu_note = ""
            if n == FP32_CASES[0][0]:
                cpu = sa.serving_attention_reference(
                    q.cpu(), k.cpu(), v.cpu(), lens.cpu(), None if rope is None else rope.cpu())
                cpu_err = compare(f"{case} plain on the card vs the CPU", want.cpu(), cpu,
                                  FP32_TOL)
                cpu_note = f"; plain on the card vs the CPU {cpu_err:.3g}"
            ms = cuda_median_ms(lambda: sa.serving_attention(q, k, v, lens, rope))
            library_ms = None
            if not with_rope:
                library_ms = cuda_median_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_mask))
            work = attention_work(2, n, 16, 64, list(lens_list), with_rope, 4)
            least, ffma = bound(*work, "tf32x3"), bound(*work, "fp32")
            log(f"[fp32] {case} b=2 h=16 d=64: max_abs_err {err:.3g} (tol {FP32_TOL} * "
                f"(1 + |plain|)), second call and with both TF32 flags on bit-identical; "
                f"TF32 control {control_err:.3g} (refused){cpu_note}; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound at the 3xTF32 rate {least['bound_ms']:.5f} ms "
                f"by {least['bound_by']} ({100 * least['bound_ms'] / ms:.1f} % of it), at the "
                f"FFMA rate {ffma['bound_ms']:.5f} ms ({100 * ffma['bound_ms'] / ms:.1f} %)"
                + (f", library (fp32 scaled_dot_product_attention, boolean key mask) "
                   f"{library_ms:.4f} ms: the kernel takes {ms / library_ms:.2f}x its time"
                   if library_ms is not None else ", no library call applies the rotation"))
            if name not in rows:
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, **least)
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        del q, k, v, qt, kt, vt, want, got
    log(f"[fp32] the JSON line's fp32 ms / plain_ms / bound_ms / library_ms are the "
        f"n = {FP32_CASES[0][0]} case's; the rotary row's library_ms is null")
    return rows


def check_backbone_against_cpu(net, dev, tag: str) -> float:
    """One fp32 backbone call (:func:`run_backbone`, b = 2, n =
    FP32_BACKBONE_N, text 120) on the card against the same module on the
    CPU, with both TF32 flags switched ON around the card's call, so that
    only the backbone's own fp32 block (`models.modules.full_fp32`) keeps
    them off: the error in units of the CPU output's scale, held to
    FP32_BACKBONE_TOL. A control replaces that block with one that turns
    TF32 on, and must exceed the limit. Returns the error."""
    import copy

    import torch

    from eraxvif5tts_tpu_torch.models import modules

    inputs = backbone_inputs(dev, 2, FP32_BACKBONE_N, 120)
    with tf32(True):
        got = run_backbone(net, inputs).cpu()
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        switch = modules.fp32_convolutions
        modules.fp32_convolutions = lambda: tf32(True)
        try:
            control = run_backbone(net, inputs).cpu()
        finally:
            modules.fp32_convolutions = switch
    if flags != (True, True):
        raise AssertionError(f"{tag} the backbone call left the TF32 flags at {flags}")
    cpu = copy.deepcopy(net).cpu()
    t0 = time.perf_counter()
    want = run_backbone(cpu, tuple(t.cpu() for t in inputs))
    cpu_s = time.perf_counter() - t0
    del cpu
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    control_err = float((control - want).abs().max()) / scale
    log(f"{tag} {type(net).__name__} fp32 call b=2 n={FP32_BACKBONE_N}, card (TF32 flags on "
        f"outside, the backbone's block turns them off) vs CPU: max error {err:.3g} of scale "
        f"{scale:.3g} (tol {FP32_BACKBONE_TOL}); control with TF32 on inside the call: "
        f"{control_err:.3g}; CPU wall {cpu_s:.2f} s")
    if not (torch.isfinite(got).all() and err <= FP32_BACKBONE_TOL):
        raise AssertionError(f"{tag} the card's fp32 backbone differs from the CPU's by {err:.3g}")
    if control_err <= FP32_BACKBONE_TOL:
        raise AssertionError(f"{tag} the TF32 control ({control_err:.3g}) passes the check")
    return err


def phase_fp32(main_wrapper, dev, mmdit_ckpt: Path) -> tuple[dict, dict]:
    """fp32 serving on the card, the JAX wrapper's default dtype: kernel 1's
    fp32 mode against its plain version (:func:`check_serving_attention_fp32`);
    the main phase's weights through a reference-format checkpoint served by
    `F5TTSWrapper("F5TTS_v1_Base")` with no `compute_dtype` (fp32 at full
    width and depth, the main phase's Vocos weights): the backbone against
    the CPU's, three `generate`s at NFE 32 with kernel 1 fp32 with rotary
    counted 22 x 32 a chunk and no launch of kernel 2, a profiled request
    beside the bf16 main phase's RTF; then the mmdit phase's checkpoint
    served in fp32, one request with kernel 1 fp32 without rotary counted.
    Returns (the JSON rows, the launches of both modes on their paths)."""
    import torch

    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    rows = check_serving_attention_fp32(dev)
    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "model.pt"
        save_reference_checkpoint_of(ckpt, main_wrapper.transformer)
        t0 = time.perf_counter()
        wrapper = F5TTSWrapper("F5TTS_v1_Base", ckpt_path=str(ckpt), vocab_char_map=vocab,
                               device=dev, nfe_step=NFE)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
    wrapper.vocoder.load_state_dict(main_wrapper.vocoder.state_dict())
    served = wrapper.transformer.state_dict()
    if wrapper.compute_dtype != "float32" or wrapper.vocoder.dtype != torch.float32:
        raise AssertionError(f"[fp32] the default wrapper serves {wrapper.compute_dtype}")
    for key, value in main_wrapper.transformer.state_dict().items():
        if served[key].dtype != torch.float32 or not torch.equal(served[key], value.float()):
            raise AssertionError(f"[fp32] {key} is not the main phase's weight in fp32")
    a = wrapper.config.arch
    log(f"[fp32] F5TTS_v1_Base dim {a.dim} depth {a.depth} heads {a.heads}x{a.dim_head}, "
        f"F5TTSWrapper with no compute_dtype: {wrapper.compute_dtype}, the main phase's "
        f"weights through a reference checkpoint, built in {built:.1f} s")
    check_backbone_against_cpu(wrapper.transformer, dev, "[fp32]")
    ref = load_reference(wrapper)
    warm_smallest(wrapper, ref, nfe_step=2)
    timed("[fp32] [dispatch]", check_dispatch, wrapper, ref, "[fp32]",
          {"serving_attention_fp32": a.depth})
    counts = generate_counted(wrapper, ref, TEXTS, NFE, "[fp32]", ("serving_attention_fp32",))
    profile_generate(wrapper, ref, TEXTS[1], NFE, "[fp32]")
    log(f"[fp32] RTF at NFE {NFE}, batch 1, same texts: fp32 {RTF['[fp32]']:.4f} against the "
        f"bf16 main phase's {RTF['[main]']:.4f} ({RTF['[fp32]'] / RTF['[main]']:.2f}x)")
    del wrapper, ref

    t0 = time.perf_counter()
    wrapper = F5TTSWrapper(model_cfg=PRESETS["F5TTS_v1_MMDiT"], ckpt_path=str(mmdit_ckpt),
                           vocab_char_map=vocab, device=dev, nfe_step=NFE)
    torch.cuda.synchronize()
    randomize((wrapper.vocoder,), SEED)  # the mmdit phase's draw
    log(f"[fp32] F5TTS_v1_MMDiT from the mmdit phase's checkpoint, "
        f"{wrapper.compute_dtype}, built in {time.perf_counter() - t0:.1f} s")
    ref = load_reference(wrapper)
    warm_smallest(wrapper, ref, nfe_step=2)
    mm_counts = generate_counted(wrapper, ref, TEXTS[:1], NFE, "[fp32] MMDiT:",
                                 ("serving_attention_fp32_norope",))
    return rows, {"serving_attention_fp32": counts["serving_attention_fp32"],
                  "serving_attention_fp32_norope": mm_counts["serving_attention_fp32_norope"]}


# fp32 training (the JAX DiT's default compute dtype): kernels 4a / 4b / 4c fp32.
# Limits between the error measured on an H100 and the TF32 control's:
FP32_GRAD_TOL = 5e-5  # kernel 4b / 4c fp32 vs plain: max |err| in units of max |plain|
# (3xTF32 products summed over up to 4096 keys or queries in another order): <= 6.2e-6 on
# an H100 (<= 1.02e-6 with FFMA kernels) vs the TF32 control's >= 6.5e-4
FP32_ATTN_TOLS = {"fwd": FP32_TOL, "dq": FP32_GRAD_TOL, "dk": FP32_GRAD_TOL,
                  "dv": FP32_GRAD_TOL}  # O: <= 1.03e-6 in 3xTF32 (5.97e-7 FFMA) vs >= 1.59e-4
# (b, n, lens) at h = 16: one tile with an empty sample, the loss check's n, the bucket's
FP32_TRAIN_CASES = ((2, 64, (64, 0)), (2, 1024, (1024, 987)), (2, 4096, (4096, 4059)))
FP32_STEP_N = 256  # the card-versus-CPU step, b = 2
FP32_STEP_LOSS_TOL = 1e-5  # its loss, relative (H100: 0; the forward is held by `full_fp32`)
FP32_STEP_GRAD_TOL = 3e-5  # its flattened gradient, relative L2: 1.9e-6 vs 2.79e-4
FP32_TRAIN_BATCH = TRAIN_BATCH  # the timed steps: the single-chip reference batch
FP32_DISTILL_BATCH = (2, 4096)


def fp32_attention_errors(got, want) -> dict:
    """[O, dq, dk, dv] against the plain version's, in the units their limits
    (FP32_ATTN_TOLS) take: O as max |err| / (1 + |plain|), each gradient as
    max |err| in units of its scale (max |plain|)."""
    errs = {"fwd": float(((got[0] - want[0]).abs() / (1 + want[0].abs())).max())}
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        errs[name] = float((g - w).abs().max() / w.abs().max())
    return errs


def check_train_attention_fp32_case(q, k, v, dout, lens, rate: float, seed: int,
                                    case: str) -> tuple:
    """Kernels 4a / 4b / 4c fp32 through `train_attention`'s autograd on one
    input against the plain version's with TF32 off: O, dq, dk, dv within
    FP32_ATTN_TOLS, the LSE within LSE_REL_TOL of the plain log sum exp, a
    second forward and backward bit-identical. Returns (the errors, the
    kernels' [O, dq, dk, dv], the plain version's, the LSE's error)."""
    import torch

    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask

    mask = lens_to_mask(lens, q.shape[1])

    def kernel(*a):
        return ta.train_attention(*a, key_valid=mask, dropout_rate=rate, seed=seed)

    got = attention_grads(kernel, q, k, v, dout)
    with tf32(False):
        want = plain_attention_grads(q, k, v, dout, lens, rate, seed)
        lse_want = plain_lse(q, k, lens)
    err = fp32_attention_errors(got, want)
    if not (all(torch.isfinite(t).all() for t in got)
            and all(err[name] <= tol for name, tol in FP32_ATTN_TOLS.items())):
        raise AssertionError(f"{case}: errors {err} beyond {FP32_ATTN_TOLS}")
    out, lse = ta.flash_forward_fp32(q, k, v, lens, rate, seed)
    lse_err = rel_l2(lse, lse_want)
    if not lse_err <= LSE_REL_TOL:
        raise AssertionError(f"{case}: LSE relative L2 error {lse_err:.3g} beyond {LSE_REL_TOL}")
    if not (torch.equal(out, got[0]) and all(
            torch.equal(g, a) for g, a in zip(got, attention_grads(kernel, q, k, v, dout)))):
        raise AssertionError(f"{case}: a second forward or backward differs")
    return err, got, want, lse_err


def tf32_control(q, k, v, dout, lens, rate: float, seed: int, want, case: str) -> dict:
    """The plain version with TF32 on, against ``want`` (the plain version
    with TF32 off): some reading must lie beyond its limit in FP32_ATTN_TOLS,
    or the limits could not see TF32. Returns the control's readings."""
    with tf32(True):
        control = fp32_attention_errors(plain_attention_grads(q, k, v, dout, lens, rate, seed),
                                        want)
    if all(control[name] <= tol for name, tol in FP32_ATTN_TOLS.items()):
        raise AssertionError(f"{case}: the TF32 control {control} passes the limits "
                             f"{FP32_ATTN_TOLS}: they cannot see TF32")
    return control


def time_train_attention(q, k, v, dout, lens, lens_list, seed: int) -> tuple:
    """Kernels 4a / 4b / 4c of q's dtype on these inputs, median CUDA-event
    times at dropout 0.1 and at keep = 1, beside the plain version's forward
    and autograd backward at dropout 0.1 and `scaled_dot_product_attention`'s
    forward and autograd backward at keep = 1 without a mask (the library has
    neither this dropout nor lens), all with TF32 off; each launch's bound
    from this run's valid keys (bf16 at the tensor cores' bf16 rate, fp32 at
    the 3xTF32 rate, the FFMA rate's returned beside). Returns (the kernels'
    times by rate, the JSON rows' numbers at dropout 0.1, the bounds, the
    FFMA bounds)."""
    import torch
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    fwd, dq, dkv = ta._LAUNCHERS[q.dtype]
    ms = {}
    for rate in (0.1, 0.0):
        out, lse = fwd(q, k, v, lens, rate, seed)
        dd = ta.row_dot(dout, out)
        ms[rate] = {"fwd": cuda_median_ms(lambda: fwd(q, k, v, lens, rate, seed)),
                    "dq": cuda_median_ms(lambda: dq(q, k, v, lens, lse, dd, dout, rate, seed)),
                    "dkv": cuda_median_ms(lambda: dkv(q, k, v, lens, lse, dd, dout, rate, seed))}
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    with tf32(False):
        plain_fwd = cuda_median_ms(
            lambda: ta.train_attention_reference(*args, lens, 0.1, seed), iters=5, warmup=1)
        ref = ta.train_attention_reference(*args, lens, 0.1, seed)
        plain_bwd = cuda_median_ms(
            lambda: torch.autograd.grad(ref, args, dout, retain_graph=True), iters=5, warmup=1)
        del ref
        lib_args = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        lib_fwd = cuda_median_ms(lambda: F.scaled_dot_product_attention(*lib_args))
        lib_out = F.scaled_dot_product_attention(*lib_args)
        lib_dout = dout.transpose(1, 2)
        lib_bwd = cuda_median_ms(
            lambda: torch.autograd.grad(lib_out, lib_args, lib_dout, retain_graph=True))
        del lib_out
    # q, k, v, dO, O / dq / dk, dv in their dtype, the fp32 LSE and D rows
    # and the lengths; QK^T (and dO V^T in the backward) and each product
    # onto an output, over each sample's valid keys (all of them where none is)
    b, n, h, d = q.shape
    size = q.element_size()
    elems, rows = b * n * h * d, b * h * n
    keys = sum(n if length <= 0 else min(length, n) for length in lens_list)
    work = 2.0 * h * d * n * keys
    work_of = {"fwd": (4 * elems * size + rows * 4 + 4 * b, 2 * work),
               "dq": (5 * elems * size + 2 * rows * 4 + 4 * b, 3 * work),
               "dkv": (6 * elems * size + 2 * rows * 4 + 4 * b, 4 * work)}
    kind = "tf32x3" if q.dtype == torch.float32 else "bf16"
    least = {name: bound(*work_of[name], kind) for name in work_of}
    ffma = {name: bound(*work_of[name], "fp32") for name in work_of}
    rows = {name: dict(ms=ms[0.1][name], plain_ms=plain_fwd if name == "fwd" else plain_bwd,
                       library_ms=lib_fwd if name == "fwd" else lib_bwd, **least[name])
            for name in least}
    return ms, rows, least, ffma


def sdpa_backend(q, k, v) -> str:
    """The backend `scaled_dot_product_attention` picks for ``[b, n, h, d]``
    q, k, v given as the yardsticks give them (heads second, no mask), by
    the dispatcher's own choice (`torch._fused_sdp_choice`)."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(*(t.transpose(1, 2) for t in (q, k, v)))).name


def train_attention_yardsticks(rows: dict) -> tuple[float, float, float, float]:
    """(plain forward, plain backward, library forward, library backward) ms
    of :func:`time_train_attention`'s rows."""
    return (rows["fwd"]["plain_ms"], rows["dq"]["plain_ms"], rows["fwd"]["library_ms"],
            rows["dq"]["library_ms"])


def check_train_attention_fp32(dev) -> dict:
    """Kernels 4a / 4b / 4c on fp32 q, k, v (`csrc/train_attention_fp32.cu`)
    through `train_attention`'s autograd against the plain version's with
    TF32 off, at b = 2, h = 16 over FP32_TRAIN_CASES at dropout 0.1 and 0:
    O, dq, dk, dv within FP32_ATTN_TOLS, the LSE within LSE_REL_TOL of the
    plain log sum exp, a second forward and backward bit-identical. At n =
    1024 and 4096 a control, the plain version with TF32 on, must be refused
    (some reading beyond its limit); at n = 1024 the plain version on the
    card is held to the same on the CPU; at n = 4096, dropout 0.1, the
    kernels run again with both TF32 flags on and must give the same bits.
    Times at n = 1024 and 4096 at dropout 0.1 and keep = 1, beside the
    plain version and, at keep = 1 without a mask, fp32
    `scaled_dot_product_attention` (TF32 off) and its backward; bounds at
    the 3xTF32 rate (the FFMA rate's beside). Returns the JSON rows (n =
    4096, the last case)."""
    import torch

    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask

    gen = torch.Generator(device=dev).manual_seed(SEED + 130)
    names = ("fwd", "dq", "dk", "dv")
    worst, abs_err, times = dict.fromkeys(names, 0.0), {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}, {}
    controls = []
    for b, n, lens_list in FP32_TRAIN_CASES:
        q, k, v, dout = (torch.randn((b, n, 16, 64), generator=gen, device=dev)
                         for _ in range(4))
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        mask = lens_to_mask(lens, n)
        seed = 0x5EED0000 + n

        for rate in (0.1, 0.0):
            case = f"train_attention fp32 b={b} n={n} lens={list(lens_list)} dropout {rate}"
            err, got, want, lse_err = check_train_attention_fp32_case(q, k, v, dout, lens, rate,
                                                                      seed, case)
            for name in names:
                worst[name] = max(worst[name], err[name])
            for name, g, w in zip(("fwd", "dq", "dkv", "dkv"), got, want):
                abs_err[name] = max(abs_err[name], float((g - w).abs().max()))
            note = ""
            if n == FP32_TRAIN_CASES[-1][1] and rate > 0.0:
                with tf32(True):  # the kernels' precision is their own
                    flagged = attention_grads(
                        lambda *a: ta.train_attention(*a, key_valid=mask, dropout_rate=rate,
                                                      seed=seed), q, k, v, dout)
                if not all(torch.equal(g, a) for g, a in zip(got, flagged)):
                    raise AssertionError(f"{case}: the kernels' results move with the TF32 flags")
                note += "; with both TF32 flags on, bit-identical"
                del flagged
            if n > FP32_TRAIN_CASES[0][1] and rate > 0.0:
                controls.append(tf32_control(q, k, v, dout, lens, rate, seed, want, case))
                note += "; TF32 control (refused) " + ", ".join(
                    f"{name} {controls[-1][name]:.3g}" for name in names)
            if n == FP32_TRAIN_CASES[1][1] and rate > 0.0:
                cpu = plain_attention_grads(q.cpu(), k.cpu(), v.cpu(), dout.cpu(), lens.cpu(),
                                            rate, seed)
                cpu_err = fp32_attention_errors([w.cpu() for w in want], cpu)
                if not all(cpu_err[name] <= FP32_ATTN_TOLS[name] for name in names):
                    raise AssertionError(f"{case}: the plain version on the card differs from "
                                         f"the CPU's: {cpu_err}")
                note += "; plain on the card vs the CPU " + ", ".join(
                    f"{name} {cpu_err[name]:.3g}" for name in names)
            log(f"[train-fp32] {case}: " + ", ".join(f"{name} {err[name]:.3g}" for name in names)
                + f" (limits {FP32_TOL} * (1 + |plain|) for O, {FP32_GRAD_TOL} of the scale "
                f"for the gradients); LSE relative L2 {lse_err:.3g}; second forward and "
                f"backward bit-identical{note}")
            del got, want
        if n == FP32_TRAIN_CASES[0][1]:
            continue
        ms, times[n], least, ffma = time_train_attention(q, k, v, dout, lens, lens_list, seed)
        plain_fwd, plain_bwd, lib_fwd, lib_bwd = train_attention_yardsticks(times[n])
        keep1 = ms[0.0]
        log(f"[train-fp32] kernels b={b} n={n} lens {list(lens_list)}: at dropout 0.1 forward "
            f"{ms[0.1]['fwd']:.4f} ms, dq {ms[0.1]['dq']:.4f} ms, dk/dv {ms[0.1]['dkv']:.4f} ms "
            f"(plain forward {plain_fwd:.4f} ms, plain backward, all three gradients, "
            f"{plain_bwd:.4f} ms); at keep = 1 forward {keep1['fwd']:.4f} ms, dq "
            f"{keep1['dq']:.4f} ms, dk/dv {keep1['dkv']:.4f} ms; bounds at the 3xTF32 rate: "
            f"forward {least['fwd']['bound_ms']:.5f} ms, dq {least['dq']['bound_ms']:.5f} ms, "
            f"dk/dv {least['dkv']['bound_ms']:.5f} ms (FFMA {ffma['fwd']['bound_ms']:.5f} / "
            f"{ffma['dq']['bound_ms']:.5f} / {ffma['dkv']['bound_ms']:.5f} ms), all by "
            + "/".join(x["bound_by"] for x in least.values())
            + " (share of the bound at dropout 0.1 / keep = 1: "
            + ", ".join(f"{name} {least[name]['bound_ms'] / ms[0.1][name]:.1%} / "
                        f"{least[name]['bound_ms'] / keep1[name]:.1%}" for name in least)
            + "; of the FFMA bound: "
            + ", ".join(f"{name} {ffma[name]['bound_ms'] / ms[0.1][name]:.1%} / "
                        f"{ffma[name]['bound_ms'] / keep1[name]:.1%}" for name in ffma)
            + f"); library fp32 scaled_dot_product_attention (TF32 off) at keep = 1, no mask: "
            f"forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms; against it at keep = 1 the "
            f"forward takes {keep1['fwd'] / lib_fwd:.2f}x and dq + dk/dv "
            f"{(keep1['dq'] + keep1['dkv']) / lib_bwd:.2f}x its time")
        del q, k, v, dout
    log("[train-fp32] kernels over every case: largest errors "
        + ", ".join(f"{name} {worst[name]:.3g}" for name in names)
        + "; smallest TF32 control "
        + ", ".join(f"{name} {min(c[name] for c in controls):.3g}" for name in names)
        + f"; the JSON line's times are the n = {n} case's, ms and plain_ms at dropout 0.1, "
        "library_ms at keep = 1; dq's and dk/dv's plain_ms and library_ms are whole backwards")
    return {f"train_attention_fp32_{name}": dict(max_abs_err=abs_err[name], **times[n][name])
            for name in abs_err}


JOINT_TRAIN_N = (4160, 5120, JOINT_N)  # kernel 4 past 4096: the MMDiT's joint sequences


def check_train_attention_joint(dev) -> dict:
    """Kernels 4a / 4b / 4c in bf16 and fp32 on the MMDiT's joint sequence, at
    b = 2, h = 16 and n = 4160, 5120 (the train buckets' 1024 + 4096) and
    6144 (the serving buckets' 2048 + 4096), with lens [n, n - 37] and with
    [0, n - 37] (a sample with no valid key), at dropout 0.1 and keep = 1:
    each against the plain version within its dtype's limits (bf16:
    :func:`check_train_attention_case`, with its wrong-seed control; fp32:
    :func:`check_train_attention_fp32_case`, with a TF32 control at dropout
    0.1 that must be refused), then timed with lens [n, n - 37]
    (:func:`time_train_attention`). Returns the JSON rows' numbers at n =
    6144, ``train_attention_joint_*`` and ``train_attention_fp32_joint_*``."""
    import torch

    rows = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        gen = torch.Generator(device=dev).manual_seed(SEED + 140 + len(tag))
        errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        for n in JOINT_TRAIN_N:
            q, k, v, dout = (torch.randn((2, n, 16, 64), generator=gen, device=dev).to(dtype)
                             for _ in range(4))
            seed = 0x5EED0000 + n + len(tag)
            for lens_list in ([n, n - 37], [0, n - 37]):
                lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
                for rate in (0.1, 0.0):
                    case = f"train_attention {tag} b=2 n={n} lens={lens_list} dropout {rate}"
                    if dtype == torch.bfloat16:
                        abs_err = check_train_attention_case(q, k, v, dout, lens, rate,
                                                             seed)["abs_err"]
                        got = [abs_err[name] for name in ("fwd", "dq", "dk", "dv")]
                    else:
                        err, out, want, lse_err = check_train_attention_fp32_case(
                            q, k, v, dout, lens, rate, seed, case)
                        got = [float((g - w).abs().max()) for g, w in zip(out, want)]
                        note = ""
                        if rate > 0.0:
                            control = tf32_control(q, k, v, dout, lens, rate, seed, want, case)
                            note = "; TF32 control (refused) " + ", ".join(
                                f"{name} {c:.3g}" for name, c in control.items())
                        del out, want
                        log(f"[kernels] {case}: " + ", ".join(
                            f"{name} {e:.3g}" for name, e in err.items())
                            + f" (limits {FP32_ATTN_TOLS}); LSE relative L2 {lse_err:.3g}; "
                            f"second forward and backward bit-identical{note}")
                    for name, e in zip(("fwd", "dq", "dkv", "dkv"), got):
                        errs[name] = max(errs[name], e)
            lens_list = [n, n - 37]
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            ms, times, least, ffma = time_train_attention(q, k, v, dout, lens, lens_list,
                                                          0x5EED0000 + n)
            plain_fwd, plain_bwd, lib_fwd, lib_bwd = train_attention_yardsticks(times)
            keep1 = ms[0.0]
            log(f"[kernels] train_attention {tag} b=2 n={n} h=16 lens {lens_list}: at dropout "
                f"0.1 forward {ms[0.1]['fwd']:.4f} ms, dq {ms[0.1]['dq']:.4f} ms, dk/dv "
                f"{ms[0.1]['dkv']:.4f} ms; at keep = 1 forward {keep1['fwd']:.4f} ms, dq "
                f"{keep1['dq']:.4f} ms, dk/dv {keep1['dkv']:.4f} ms; bounds "
                + ", ".join(f"{name} {x['bound_ms']:.5f} ms by {x['bound_by']} "
                            f"({x['bound_ms'] / keep1[name]:.1%} of keep 1)"
                            for name, x in least.items())
                + (" at the 3xTF32 rate (FFMA " + " / ".join(
                    f"{x['bound_ms']:.5f}" for x in ffma.values()) + " ms)"
                   if dtype == torch.float32 else "")
                + f"; plain forward {plain_fwd:.4f} ms, plain backward {plain_bwd:.4f} ms; "
                f"library scaled_dot_product_attention{' (TF32 off)' if tag == 'fp32' else ''} "
                f"at keep = 1, no mask: forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms; "
                f"against it at keep = 1 the forward takes {keep1['fwd'] / lib_fwd:.2f}x and "
                f"dq + dk/dv {(keep1['dq'] + keep1['dkv']) / lib_bwd:.2f}x its time")
            del q, k, v, dout
        prefix = "train_attention_joint" if tag == "bf16" else "train_attention_fp32_joint"
        rows.update({f"{prefix}_{name}": dict(max_abs_err=errs[name], **times[name])
                     for name in errs})
    log(f"[kernels] the JSON line's joint training rows are the n = {JOINT_N} case's, ms and "
        "plain_ms at dropout 0.1, library_ms at keep = 1; dq's and dk/dv's plain_ms and "
        "library_ms are whole backwards; max_abs_err over n = "
        + ", ".join(str(n) for n in JOINT_TRAIN_N) + ", both lens sets and both rates")
    return rows


def fp32_step(trainer, state, batch, draws) -> tuple[float, float, object]:
    """One `train_step` whose update is not applied: (its loss, its gradient
    norm, the flattened gradient it would have applied)."""
    import torch

    seen = {}

    def capture(state, grads, norm):
        seen["grad"] = torch.cat([g.flatten() for g in grads])

    trainer._apply = capture
    try:
        _, metrics = trainer.train_step(state, batch, draws)
    finally:
        del trainer._apply
    if metrics["applied"] != 1.0:
        raise AssertionError(f"the compared step was not finite: {metrics}")
    return metrics["loss"], metrics["grad_norm"], seen["grad"]


def check_fp32_step_against_cpu(cfm, dev) -> None:
    """One fp32 `Trainer.train_step` (the update withheld) at b = 2, n =
    FP32_STEP_N on the card against the same step on the CPU, on the same
    draws: the loss within FP32_STEP_LOSS_TOL and the whole gradient within
    FP32_STEP_GRAD_TOL (relative L2), with both TF32 flags ON around the
    card's step, so that only the trainer's fp32 block keeps its backward and
    the checkpointed recompute in fp32. A control takes that block away
    (the forward keeps the backbone's own block): its gradient must differ
    beyond the limit."""
    import copy

    import torch

    from eraxvif5tts_tpu_torch.training import trainer as trainer_module

    dit = cfm.transformer
    mel, text, lens, draws = loss_batch(dev, SEED + 31, len(dit.transformer_blocks),
                                        n=FP32_STEP_N)
    batch = {"mel": mel, "text": text, "lens": lens}
    spec = trainer_module.make_optimizer(num_warmup_updates=1, total_updates=1000)
    trainer = trainer_module.Trainer(cfm=cfm, optimizer=spec)
    state = trainer.init_state()
    with tf32(True):
        loss, norm, grad = fp32_step(trainer, state, batch, draws)
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        held = trainer_module.fp32_when
        trainer_module.fp32_when = lambda dtype: contextlib.nullcontext()
        try:
            _, control_norm, control = fp32_step(trainer, state, batch, draws)
        finally:
            trainer_module.fp32_when = held
    if flags != (True, True):
        raise AssertionError(f"[train-fp32] the step left the TF32 flags at {flags}")
    del state, trainer
    t0 = time.perf_counter()
    cpu_cfm = type(cfm)(copy.deepcopy(dit).cpu())
    cpu_trainer = trainer_module.Trainer(cfm=cpu_cfm, optimizer=spec)
    cpu_draws = dataclasses.replace(draws, **{
        f: getattr(draws, f).cpu() for f in ("frac", "rand", "x0", "time", "drop_audio",
                                             "drop_cond")})
    cpu_loss, cpu_norm, cpu_grad = fp32_step(cpu_trainer, cpu_trainer.init_state(),
                                             {k: t.cpu() for k, t in batch.items()}, cpu_draws)
    cpu_s = time.perf_counter() - t0
    del cpu_cfm, cpu_trainer
    loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
    grad_err, control_err = rel_l2(grad.cpu(), cpu_grad), rel_l2(control.cpu(), cpu_grad)
    log(f"[train-fp32] Trainer.train_step b=2 n={FP32_STEP_N} fp32, card (TF32 flags on "
        f"outside the step) vs CPU: loss {loss:.7f} vs {cpu_loss:.7f} (relative {loss_err:.3g}, "
        f"tol {FP32_STEP_LOSS_TOL}), grad_norm {norm:.6f} vs {cpu_norm:.6f}, gradient relative "
        f"L2 {grad_err:.3g} (tol {FP32_STEP_GRAD_TOL}); control without the trainer's fp32 "
        f"block (TF32 in the backward and the recompute): gradient {control_err:.3g}, "
        f"grad_norm {control_norm:.6f}; CPU step {cpu_s:.1f} s")
    if not (math.isfinite(loss) and loss_err <= FP32_STEP_LOSS_TOL
            and grad_err <= FP32_STEP_GRAD_TOL):
        raise AssertionError("[train-fp32] the card's fp32 step differs from the CPU's")
    if control_err <= FP32_STEP_GRAD_TOL:
        raise AssertionError(f"[train-fp32] the TF32 control ({control_err:.3g}) passes the "
                             "check: it cannot see TF32 in the backward")


def prune_student(sd: dict, depth: int, target: int) -> tuple[list, dict]:
    """The blocks the pruner keeps of a ``depth``-block state dict (numpy)
    by its own scores, as the compress phase's CLI chooses them, and the
    pruned state dict as tensors."""
    import numpy as np
    import torch

    from eraxvif5tts_tpu_torch.compression.pruner import (
        block_importance_scores,
        prune_state_dict,
        select_blocks_to_keep,
    )

    keep = select_blocks_to_keep(block_importance_scores(sd)[0], depth, target)
    return keep, {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in prune_state_dict(sd, keep).items()}


def fp32_counts() -> list:
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    return [fn.launches for fn in (ta.flash_forward_fp32, ta.flash_dq_fp32, ta.flash_dkv_fp32,
                                   ta.flash_forward, ta.flash_dq, ta.flash_dkv)]


def phase_train_fp32(dev, arch=None) -> tuple[dict, dict]:
    """fp32 training, the JAX DiT's default compute dtype: kernels 4a / 4b /
    4c fp32 against their plain version (:func:`check_train_attention_fp32`);
    `F5TTS_v1_Base` at full width and depth with fp32 parameters and no
    compute dtype (fp32), dropout 0.1, blocks checkpointed: one step against
    the CPU's (:func:`check_fp32_step_against_cpu`), then `Trainer.train_step`
    on FP32_TRAIN_BATCH, a warm-up and two timed steps (dropout 0.1, then 0,
    the role of the library's flash kernel at keep = 1) with the fp32 kernels
    counted 2 x depth / depth / depth a step and the bf16 ones at 0, a
    profiled step, four applied updates; last one fp32 `DistillTrainer` step
    at FP32_DISTILL_BATCH with this model as the teacher and a 14-block
    student pruned from its first weights by the pruner's own scores, as the
    compress phase prunes its teacher's checkpoint. Returns (the JSON rows,
    the launches of the timed steps)."""
    import torch

    from eraxvif5tts_tpu_torch.models.cfm import CFM
    from eraxvif5tts_tpu_torch.models.dit import DiT
    from eraxvif5tts_tpu_torch.training.distill import DistillConfig, DistillTrainer
    from eraxvif5tts_tpu_torch.training.trainer import Trainer, batch_seed, make_optimizer

    rows = check_train_attention_fp32(dev)
    t0 = time.perf_counter()
    arch = arch or train_arch()
    dit = DiT(arch, text_num_embeds=len(VOCAB_CHARS), mel_dim=100).to(dev)
    randomize((dit,), SEED)
    cfm = CFM(dit.train())
    if dit.dtype != torch.float32:
        raise AssertionError(f"[train-fp32] the DiT computes in {dit.dtype}")
    log(f"[train-fp32] F5TTS_v1_Base dim {arch.dim} depth {arch.depth} heads {arch.heads}x"
        f"{arch.dim_head}: {sum(p.numel() for p in dit.parameters()) / 1e6:.1f} M fp32 "
        f"parameters, no compute_dtype (fp32 compute), dropout {arch.dropout}, remat "
        f"{arch.remat_policy}, N(0, {WEIGHT_STD}) seed {SEED}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    # the distill step's 14-block student, pruned from this checkpoint as the
    # compress phase prunes its teacher's: the pruner's numpy scores (~10 s)
    # run in a thread under the card-versus-CPU step, and end before the
    # timed steps, whose walls hold the host's dispatch
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    pruned = pool.submit(prune_student, {k: t.detach().cpu().numpy()
                                         for k, t in dit.state_dict().items()},
                         arch.depth, COMPRESS_DEPTHS[0])
    check_fp32_step_against_cpu(cfm, dev)
    t0 = time.perf_counter()
    keep, student_sd = pruned.result()
    pool.shutdown()
    log(f"[train-fp32] pruning thread joined {time.perf_counter() - t0:.1f} s after the "
        "card-versus-CPU step")

    trainer = Trainer(cfm=cfm, optimizer=make_optimizer(num_warmup_updates=1,
                                                         total_updates=1000))
    state = trainer.init_state()
    params0 = [p.detach().clone() for p in dit.parameters()]
    b, n = FP32_TRAIN_BATCH
    depth = arch.depth
    want = [2 * depth, depth, depth, 0, 0, 0]
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    for fn in (ta.flash_forward_fp32, ta.flash_dq_fp32, ta.flash_dkv_fp32, ta.flash_forward,
               ta.flash_dq, ta.flash_dkv):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    walls = {}
    for i, rate in enumerate((0.1, 0.1, 0.0)):  # a warm-up, then timed at 0.1 and at 0
        dit.arch = dataclasses.replace(dit.arch, dropout=rate)
        before = fp32_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(
            state, train_batch(dev, SEED + 30 + i, (b, n)),
            torch.Generator(device=dev).manual_seed(batch_seed(SEED, 2, i)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if i:
            walls[rate] = wall
        counts = [c - c0 for c, c0 in zip(fp32_counts(), before)]
        log(f"[train-fp32] step {i + 1} ({'warm-up' if i == 0 else 'timed'}) b={b} n={n} "
            f"dropout {rate}: loss {metrics['loss']:.5f}, grad_norm {metrics['grad_norm']:.5f}, "
            f"applied {metrics['applied']:.0f}, {wall:.3f} s ({b * n / wall:.0f} frames/s); "
            f"launches fp32 fwd/dq/dkv, bf16 fwd/dq/dkv {counts}")
        if not (math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])
                and metrics["applied"] == 1.0):
            raise AssertionError(f"[train-fp32] step {i + 1}: non-finite or not applied")
        if counts != want:
            raise AssertionError(f"[train-fp32] step {i + 1}: launches {counts}, expected {want}")
    counts = fp32_counts()
    launches = dict(zip(("train_attention_fp32_fwd", "train_attention_fp32_dq",
                         "train_attention_fp32_dkv"), counts))
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[train-fp32] timed steps b={b} n={n}: dropout 0.1 {walls[0.1]:.3f} s "
        f"({b * n / walls[0.1]:.0f} frames/s), dropout 0 {walls[0.0]:.3f} s "
        f"({b * n / walls[0.0]:.0f} frames/s); peak memory {peak / 2**30:.2f} GiB")
    dit.arch = dataclasses.replace(dit.arch, dropout=0.1)
    profile_train_step(trainer, state, train_batch(dev, SEED + 33, (b, n)), dev, walls[0.1],
                       "[train-fp32]")
    moved = sum(not torch.equal(p, p0) for p, p0 in zip(dit.parameters(), params0))
    log(f"[train-fp32] {state.step} updates applied; parameter tensors changed "
        f"{moved}/{len(params0)}")
    if state.step != 4 or moved != len(params0):
        raise AssertionError("[train-fp32] four updates did not move every parameter tensor")
    del params0, state, trainer

    # one fp32 distillation step: this model the teacher, the student pruned from it
    t0 = time.perf_counter()
    student = DiT(dataclasses.replace(arch, depth=COMPRESS_DEPTHS[0]), len(VOCAB_CHARS), 100)
    student.load_state_dict(student_sd, strict=True)
    del student_sd
    trainer = DistillTrainer(student_cfm=CFM(student.to(dev)), teacher_transformer=dit,
                             optimizer=make_optimizer(learning_rate=1e-5, num_warmup_updates=1,
                                                      total_updates=1000, decay_type="cosine"),
                             config=DistillConfig())
    state = trainer.init_state()
    built = time.perf_counter() - t0
    before = fp32_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = trainer.train_step(
        state, train_batch(dev, SEED + 34, FP32_DISTILL_BATCH),
        torch.Generator(device=dev).manual_seed(batch_seed(SEED, 3, 0)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [c - c0 for c, c0 in zip(fp32_counts(), before)]
    depth_s = COMPRESS_DEPTHS[0]
    log(f"[train-fp32] DistillTrainer step, teacher this model (fp32, eval), student "
        f"{depth_s} blocks {keep} (pruner's scores; built in {built:.1f} s), b, n = "
        f"{FP32_DISTILL_BATCH}: " + ", ".join(f"{k} {v:.5f}" for k, v in metrics.items())
        + f"; {wall:.3f} s (first step: no warm-up); launches fp32 fwd/dq/dkv, bf16 "
        f"fwd/dq/dkv {counts}")
    if not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"]:
        raise AssertionError("[train-fp32] the distillation step is not finite")
    if counts != [2 * depth_s, depth_s, depth_s, 0, 0, 0]:
        raise AssertionError(f"[train-fp32] distill launches {counts}")
    return rows, launches


# MMDiT training (dropout 0: the JAX MMDiT trains at no other rate)
MMDIT_TRAIN_JOINT = (1024, 4096)  # text bucket + mel bucket: the JAX training buckets' longest
# the largest b <= 9 that fits without checkpointing (H100 80GB): 9 in bf16 (peak
# 48.45 GiB allocated, 49.40 GiB reserved). In fp32 b = 9 fits too, but at 76.74
# GiB allocated and 78.37 GiB reserved of the card's 79.2 another run's
# allocator state could fail it: the smoke takes 8
MMDIT_TRAIN_BATCH = {"bf16": 9, "fp32": 8}
MMDIT_CHECK = (2, 256, 1024)  # b, text bucket, mel frames of the steps held against plain
MMDIT_CHECK_SEEDS = (SEED + 50, SEED + 53)  # their batches (and draws: the seed + 1)
# those steps in bf16, kernel 4 vs plain attention, relative (the gradients'
# limits lie between the error measured on an H100 and a control's, the plain
# step with one 64-key tile of the joint sequence masked in every block; the
# two seeds): gradient 3.99e-3 / 3.77e-3 vs 1.37e-2 / 1.9e-2, q / k / v
# projections' gradient 3.16e-3 / 3.45e-3 vs 5.9e-2 / 8.1e-2. The loss cannot
# see a lost tile at bf16 (it moved by 4.45e-6 / 1.47e-5, the control by
# 1.34e-5 / 4.02e-5, and each bf16 step's loss lay 2.6e-5 to 4.1e-5 from the
# fp32 step's): it is held only within bf16 rounding, and its control is
# logged. Both bf16 steps are held against an fp32-compute step of the same
# weights and batch as well: the kernel's gradients may lie no further from it
# than MMDIT_ROUNDING times the plain bf16 step's do (gradient 7.84e-3 vs
# 7.88e-3 / 7.66e-3 vs 7.64e-3, q / k / v 1.38e-2 vs 1.38e-2 / 1.62e-2 vs
# 1.60e-2), so that the error between the two is bf16 rounding and not the
# kernel's
MMDIT_TOLS = {"loss": 1e-4, "gradient L2": 7e-3, "q/k/v gradient L2": 1.4e-2}
MMDIT_ROUNDING = 1.25


def check_mmdit_refuses_dropout(trainer, state, dev, tag: str) -> None:
    """A training step of the MMDiT at dropout 0.1 raises the port's
    ValueError before any kernel launches and leaves the state as it was."""
    import torch

    net = state.model
    batch = train_batch(dev, SEED + 52, (2, 256), 64)
    before, step = fp32_counts() + [serving_counts()], state.step
    net.arch = dataclasses.replace(net.arch, dropout=0.1)
    try:
        trainer.train_step(state, batch, torch.Generator(device=dev).manual_seed(SEED))
    except ValueError as refusal:
        message = str(refusal)
    else:
        raise AssertionError(f"{tag} a training step at dropout 0.1 was not refused")
    finally:
        net.arch = dataclasses.replace(net.arch, dropout=0.0)
    torch.cuda.synchronize()
    if fp32_counts() + [serving_counts()] != before or state.step != step:
        raise AssertionError(f"{tag} the refused step launched a kernel or moved the state")
    log(f"{tag} dropout 0.1 refused before any launch: {message[:150]}...")


def check_mmdit_step_against_plain(trainer, state, dev, tag: str) -> None:
    """For each seed of MMDIT_CHECK_SEEDS, one `Trainer.train_step` (the
    update withheld) of the full MMDiT at b, text, mel = MMDIT_CHECK with
    kernel 4 against the same step with `train_attention.plain` set, on the
    same batch and draws: the loss, the whole gradient, the q / k / v
    projections' (both streams) and the worst single parameter's gradient
    (relative L2). bf16 compute is held to MMDIT_TOLS, and a control, the
    plain step with the last 64-key tile of the joint sequence masked in
    every block (what a kernel that lost one tile would give), must exceed
    each gradient's limit (bf16 rounding moves the loss as much); both bf16
    steps are also held against the plain step in fp32 compute on the same
    weights, the kernel's gradients within MMDIT_ROUNDING times the plain
    bf16 step's distance. fp32 compute is held to the fp32 step's
    limits (FP32_STEP_LOSS_TOL, FP32_STEP_GRAD_TOL) with both TF32 flags on
    around the step, and a control (the plain step without the trainer's
    fp32 block) must exceed the gradient's limit."""
    import torch

    from eraxvif5tts_tpu_torch.models.cfm import LossDraws
    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.training import trainer as trainer_module

    net = state.model
    fp32 = net.dtype == torch.float32
    b, nt, n = MMDIT_CHECK
    names = [name for name, _ in net.named_parameters()]
    sizes = [p.numel() for p in net.parameters()]

    def step(batch, draws, plain: bool, held: bool = True, lost_tile: bool = False,
             compute_fp32: bool = False):
        ta.train_attention.plain = plain
        hold, compute = trainer_module.fp32_when, net.compute_dtype
        if not held:
            trainer_module.fp32_when = lambda dtype: contextlib.nullcontext()
        if compute_fp32:
            net.compute_dtype = None
        try:
            with tf32(fp32), lost_tile_attention() if lost_tile else contextlib.nullcontext():
                return fp32_step(trainer, state, batch, draws)
        finally:
            ta.train_attention.plain = False
            trainer_module.fp32_when = hold
            net.compute_dtype = compute

    qkv = [i for i, name in enumerate(names)
           if name.split(".")[-2] in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c")]

    def distance(x, want):
        parts = [torch.split(y[2], sizes) for y in (x, want)]
        return {"loss": abs(x[0] - want[0]) / abs(want[0]), "gradient L2": rel_l2(x[2], want[2]),
                "q/k/v gradient L2": rel_l2(torch.cat([parts[0][i] for i in qkv]),
                                            torch.cat([parts[1][i] for i in qkv]))}

    for seed in MMDIT_CHECK_SEEDS:
        batch = train_batch(dev, seed, (b, n), nt)
        draws = LossDraws.sample(torch.Generator(device=dev).manual_seed(seed + 1), b, n, 100,
                                 net.arch.depth)
        got, want = step(batch, draws, False), step(batch, draws, True)
        parts = [torch.split(x[2], sizes) for x in (got, want)]
        worst = max((rel_l2(g, w), names[i]) for i, (g, w) in enumerate(zip(*parts))
                    if w.norm() > 0)
        err = distance(got, want)
        if fp32:
            tols = {"loss": FP32_STEP_LOSS_TOL, "gradient L2": FP32_STEP_GRAD_TOL}
            control = {"gradient L2": rel_l2(step(batch, draws, True, held=False)[2], want[2])}
            what = "plain, without the trainer's fp32 block: TF32 in the step"
        else:
            tols = MMDIT_TOLS
            control = distance(step(batch, draws, True, lost_tile=True), want)
            what = "plain, the last 64-key tile masked in every block"
        log(f"{tag} seed {seed}: Trainer.train_step b={b} text {nt} + mel {n} = {nt + n}, "
            f"kernel 4 vs plain attention{' (TF32 flags on outside the step)' if fp32 else ''}: "
            f"loss {got[0]:.6f} vs {want[0]:.6f}, grad_norm {got[1]:.5f} vs {want[1]:.5f}; "
            "relative errors (tol, or logged where none): "
            + ", ".join(f"{name} {e:.3g} ({tols.get(name, 'logged')})" for name, e in err.items())
            + f", worst single parameter {worst[0]:.3g} ({worst[1]}); control ({what}) "
            + ", ".join(f"{name} {c:.3g}" for name, c in control.items()))
        if not (torch.isfinite(got[2]).all() and all(err[name] <= t for name, t in tols.items())):
            raise AssertionError(f"{tag} seed {seed}: the step with kernel 4 differs from plain: "
                                 f"{err}")
        if not all(control[name] > tols[name] for name in control
                   if name in tols and (fp32 or name != "loss")):
            raise AssertionError(f"{tag} seed {seed}: the control ({what}) moves the step by "
                                 f"only {control}, within the limits {tols}")
        if fp32:
            continue
        exact = step(batch, draws, True, compute_fp32=True)
        rounding = {"kernel": distance(got, exact), "plain": distance(want, exact)}
        log(f"{tag} seed {seed}: against the plain step in fp32 compute (same weights, batch "
            "and draws), relative: " + "; ".join(
                f"{who} bf16 step " + ", ".join(f"{name} {e:.3g}" for name, e in d.items())
                for who, d in rounding.items()))
        far = {name: e for name, e in rounding["kernel"].items()
               if name != "loss" and e > MMDIT_ROUNDING * rounding["plain"][name]}
        if far:
            raise AssertionError(f"{tag} seed {seed}: the kernel's bf16 step lies further from "
                                 f"fp32 than {MMDIT_ROUNDING} x the plain bf16 step's: {far}")


def phase_mmdit_train(dev, cfg=None) -> dict:
    """MMDiT training at full width (``cfg``: the configuration, whose depth
    the smoke cuts): F5TTS_v1_MMDiT at dropout 0 (the
    preset's 0.1 is refused, as the JAX MMDiT cannot train at it) from
    seeded N(0, 0.02) weights, in bf16 compute and then in fp32, each with
    fp32 parameters and no activation checkpointing (the JAX MMDiT has
    none): the refusal of dropout 0.1 before any launch (bf16), one step
    against plain attention (:func:`check_mmdit_step_against_plain`), then
    `Trainer.train_step` at MMDIT_TRAIN_BATCH x the joint MMDIT_TRAIN_JOINT
    (a warm-up and two timed steps in bf16, a warm-up and one in fp32) with
    kernel 4 of the step's dtype counted depth / depth / depth a step (no
    recompute) and the other dtype's at 0, the peak memory, and a profiled
    step. Returns the joint rows' launches over those steps."""
    import torch

    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.models.cfm import CFM
    from eraxvif5tts_tpu_torch.models.mmdit import MMDiT
    from eraxvif5tts_tpu_torch.training.trainer import Trainer, batch_seed, make_optimizer

    cfg = cfg or PRESETS["F5TTS_v1_MMDiT"]
    arch = dataclasses.replace(cfg.arch, dropout=0.0)
    nt, n = MMDIT_TRAIN_JOINT
    torch.cuda.empty_cache()  # the fp32 steps need most of the card
    depth = arch.depth
    launches = {}
    for label, steps in (("bf16", 3), ("fp32", 2)):
        tag = f"[mmdit-train {label}]"
        t0 = time.perf_counter()
        net = MMDiT(arch, len(VOCAB_CHARS), 100,
                    compute_dtype=torch.bfloat16 if label == "bf16" else None).to(dev)
        randomize((net,), SEED + 6)
        trainer = Trainer(cfm=CFM(net.train()),
                          optimizer=make_optimizer(num_warmup_updates=1, total_updates=1000))
        state = trainer.init_state()
        log(f"{tag} {cfg.name} dim {arch.dim} depth {depth} heads {arch.heads}x{arch.dim_head} "
            f"ff_mult {arch.ff_mult}: {sum(p.numel() for p in net.parameters()) / 1e6:.1f} M "
            f"fp32 parameters, {net.dtype} compute, dropout 0, no checkpointing, "
            f"N(0, {WEIGHT_STD}) seed {SEED + 6}, built in {time.perf_counter() - t0:.1f} s")
        if label == "bf16":
            check_mmdit_refuses_dropout(trainer, state, dev, tag)
        check_mmdit_step_against_plain(trainer, state, dev, tag)
        b = MMDIT_TRAIN_BATCH[label]
        want = [0, 0, 0, depth, depth, depth] if label == "bf16" else [depth] * 3 + [0] * 3
        before = fp32_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for i in range(steps):
            batch = train_batch(dev, SEED + 60 + i, (b, n), nt)
            counts = fp32_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(
                state, batch, torch.Generator(device=dev).manual_seed(batch_seed(SEED, 4, i)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = [c - c0 for c, c0 in zip(fp32_counts(), counts)]
            log(f"{tag} step {i + 1} ({'warm-up' if i == 0 else 'timed'}) b={b} text {nt} + "
                f"mel {n}: loss {metrics['loss']:.5f}, grad_norm {metrics['grad_norm']:.5f}, "
                f"applied {metrics['applied']:.0f}, {walls[-1]:.3f} s; launches fp32 "
                f"fwd/dq/dkv, bf16 fwd/dq/dkv {counts}")
            if not (math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])
                    and metrics["applied"] == 1.0):
                raise AssertionError(f"{tag} step {i + 1}: non-finite or not applied")
            if counts != want:
                raise AssertionError(f"{tag} step {i + 1}: launches {counts}, expected {want}")
        total = [c - c0 for c, c0 in zip(fp32_counts(), before)]
        peak = torch.cuda.max_memory_allocated(dev)
        reserved = torch.cuda.max_memory_reserved(dev)
        wall = statistics.median(walls[1:])
        log(f"{tag} timed step(s) b={b} x (text {nt} + mel {n}): {wall:.3f} s a step, "
            f"{b * n / wall:.0f} mel frames/s ({b * (nt + n) / wall:.0f} joint positions/s); "
            f"peak memory {peak / 2**30:.2f} GiB allocated, {reserved / 2**30:.2f} GiB "
            f"reserved, of {torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}")
        prefix = "train_attention_joint" if label == "bf16" else "train_attention_fp32_joint"
        counted = total[3:] if label == "bf16" else total[:3]
        launches.update({f"{prefix}_{name}": c for name, c in zip(("fwd", "dq", "dkv"), counted)})
        profile_train_step(trainer, state, train_batch(dev, SEED + 70, (b, n), nt), dev, wall,
                           tag)
        del net, trainer, state, batch
        torch.cuda.empty_cache()
    return launches


def head_dim_config(tmp: Path, heads: int, dim_head: int, tag: str):
    """`configs/F5TTS_v1_Base.yaml` with `model.arch` ``heads`` and
    ``dim_head`` (the flagship's inner width 1024 as heads x dim_head),
    written into ``tmp`` and loaded by the port's config loader: (the model
    config, the file)."""
    from eraxvif5tts_tpu_torch.configs import load_model_config

    text = (ROOT / "configs" / "F5TTS_v1_Base.yaml").read_text()
    if text.count("    heads: 16\n") != 1:
        raise AssertionError("configs/F5TTS_v1_Base.yaml: no single `heads: 16` line")
    path = tmp / f"F5TTS_v1_Base_{heads}x{dim_head}.yaml"
    path.write_text(text.replace("    heads: 16\n",
                                 f"    heads: {heads}\n    dim_head: {dim_head}\n"))
    cfg = load_model_config(str(path))
    a = cfg.arch
    if (a.dim, a.depth, a.heads, a.dim_head, a.ff_mult) != (1024, 22, heads, dim_head, 2):
        raise AssertionError(f"{tag} the loaded arch is {a}")
    return cfg, path


def forward_build_notes(log_text: str, d: int) -> list[str]:
    """What ptxas said of the forward core's instantiations at head dim ``d``
    (the training forward and the serving attention, each mode) in a build
    log: each one's registers and spills, then every note (``(C75..)``)
    that names it."""
    lines = [line.strip() for line in log_text.splitlines()]
    marks = (f"train_attention_fwd_kernelILi{d}E", f"serving_attention_kernelILi{d}E")
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(mark in line for mark in marks):
            name = line.split("'")[1] if "'" in line else line
            report = []
            for x in lines[i + 1:i + 5]:
                if "Compiling entry" in x:
                    break
                if "registers" in x or "spill" in x:
                    report.append(x.replace("ptxas info    : ", ""))
            found.append(f"{short_kernel_name(name)}: {' '.join(report)}")
    for line in lines:
        if "(C75" in line and any(mark in line for mark in marks):
            name = line.rsplit("'", 2)[-2] if line.count("'") >= 2 else ""
            found.append(f"{short_kernel_name(name)} note: "
                         + line.replace("ptxas info    : ", "").split(" in function")[0])
    return found


def short_kernel_name(mangled: str) -> str:
    """``train_attention_fwd_kernel<128, 1>`` from an instantiation's
    mangled name (the kernel and its template arguments, in order)."""
    import re

    for base in ("train_attention_fwd_kernel", "serving_attention_kernel"):
        if base in mangled:
            tail = mangled.split(base, 1)[1].split("EEv")[0] + "E"
            args = ", ".join(value for _, value in re.findall(r"L([ib])(\d+)E", tail))
            return f"{base}<{args}>"
    return mangled


def log_forward_build(tag: str, d: int) -> None:
    """Logs :func:`forward_build_notes` of this process's build at ``d``."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    notes = forward_build_notes(_cuda.kernels().log, d)
    for line in notes:
        log(f"{tag} ptxas, forward core at d = {d}: {line}")
    if not notes:
        log(f"{tag} ptxas, forward core at d = {d}: no report in this process's build log "
            "(a cached build)")


def check_d128_geometry() -> None:
    """The constants every built attention kernel reports at d = 64 and 128
    against the ones `ops/train_attention.py` states, and the C interface
    refusing another head dim: its geometry entries and a launch at d = 32
    return a non-zero code (no kernel runs)."""
    import ctypes

    import torch

    from eraxvif5tts_tpu_torch.ops import _cuda
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    built_keys = ("rows", "stages", "threads", "shared_bytes")
    for d in ta.HEAD_DIMS:
        fwd, bwd = ta.forward_geometry(2, 4096, 16, d), ta.backward_geometry(2, 4096, 16, d)
        f32, b32 = (ta.forward_geometry_fp32(2, 4096, 16, d),
                    ta.backward_geometry_fp32(2, 4096, 16, d))
        stated = {"forward": {key: fwd[key] for key in ta.FORWARD_BUILT},
                  "backward": {key: bwd[key] for key in built_keys},
                  "fp32": dict({key: f32[key] for key in ta.FP32_FORWARD_BUILT},
                               **fp32_backward_stated(b32)),
                  "fp32 serving": {key: f32[key] for key in ta.FP32_FORWARD_BUILT}}
        built = {"forward": ta.kernel_forward_geometry(d),
                 "backward": ta.kernel_backward_geometry(d),
                 "fp32": ta.kernel_geometry_fp32(d), "fp32 serving": sa.kernel_geometry_fp32(d)}
        if built != stated:
            raise AssertionError(f"[d128] built geometry at d = {d}: {built}; stated {stated}")
        log(f"[d128] built geometry at d = {d} equals the stated one: bf16 forward "
            f"{built['forward']} (registers {fwd['registers']}, "
            f"{'overlapped' if fwd['overlap'] else 'serial'} products), backward "
            f"{built['backward']}; "
            f"fp32 {built['fp32']} ({f32['sets']} warp set(s) of four, key tiles of "
            f"{f32['key_tile']}, Q split {'once' if f32['q_split'] else 'at each use'}), "
            f"{f32['blocks_per_sm']} block(s) an SM")
    lib = _cuda.kernels().lib
    out = (ctypes.c_int * len(ta.FP32_FORWARD_BUILT + ta.FP32_BACKWARD_BUILT))()
    refused = {name: getattr(lib, name)(32, out) for name in (
        "erax_flash_forward_geometry", "erax_train_attention_bwd_geometry",
        "erax_train_attention_fp32_geometry", "erax_serving_attention_fp32_geometry")}
    q = torch.zeros((1, 64, 2, 32), dtype=torch.bfloat16, device="cuda")
    lens = torch.full((1,), 64, dtype=torch.int32, device="cuda")
    refused["erax_serving_attention"] = lib.erax_serving_attention(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), lens.data_ptr(), None, None, q.data_ptr(),
        1, 64, 2, 32, 0, 1.0, _cuda.stream_ptr(q.device))
    if not all(refused.values()):
        raise AssertionError(f"[d128] an entry point took head dim 32: {refused}")
    log(f"[d128] head dim 32 refused by the C interface (non-zero codes, no launch): {refused}")


def zero_upper_half(t):
    """``t`` with the second half of its head columns zeroed (64.. of 128,
    128.. of 256): what a kernel that read only the first half of a head's
    panels would see."""
    bad = t.clone()
    bad[..., t.shape[-1] // 2:] = 0
    return bad


def rotated_outside(x, rope):
    """``x [b, n, h, d]`` rotated as the serving attention rotates it, heads
    second: the library yardstick's q or k for a rotary row."""
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa

    return sa._rotate(x, rope).transpose(1, 2)


def check_serving_attention_at(dev, tag: str, h: int, d: int, seed: int, cases) -> dict:
    """Kernel 1 at head dim ``d`` (b = 2, ``h`` heads) in bf16 and fp32
    against its plain version on ``cases``, (n, lens, rotary modes) each:
    within TOL (bf16) or FP32_TOL (fp32, plain with TF32 off) * (1 +
    |plain|), a second call bit-identical. Beside each reading two planted
    faults, the plain version with the second half of V's and of K's head
    columns zeroed, which the check must refuse. At the first case's n the
    kernel, the plain version and the library yardstick are timed (bf16:
    `scaled_dot_product_attention` on the flash backend, which takes no key
    mask; fp32: with the boolean key mask, TF32 off; on the rotary rows with
    q and k rotated outside it, in the timing) and the bound computed from
    these inputs. Returns the JSON rows of that n, named
    ``serving_attention[_fp32]_<tag>[_norope]``."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows, label = {}, tag.strip("[]")
    timed_n = cases[0][0]
    for dtype, dtag, tol in ((torch.bfloat16, "", TOL), (torch.float32, "_fp32", FP32_TOL)):
        for n, lens_list, modes in cases:
            q, k, v = (torch.randn((2, n, h, d), generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            lens = torch.tensor(lens_list, device=dev)
            for with_rope in modes:
                name = f"serving_attention{dtag}_{label}" + ("" if with_rope else "_norope")
                case = f"{name} n={n} lens={list(lens_list)}"
                rope = rotary_freqs(n, d, device=dev) if with_rope else None
                with tf32(False):
                    want = sa.serving_attention_reference(q, k, v, lens, rope)
                    faults = {}
                    for which, args in (("v", (q, k, zero_upper_half(v))),
                                        ("k", (q, zero_upper_half(k), v))):
                        bad = sa.serving_attention_reference(*args, lens, rope)
                        faults[which] = float(((bad.float() - want.float()).abs()
                                               / (1 + want.float().abs())).max())
                        del bad
                got = sa.serving_attention(q, k, v, lens, rope)
                err = compare(case, got, want, tol)
                if not torch.equal(got, sa.serving_attention(q, k, v, lens, rope)):
                    raise AssertionError(f"{case}: a second call on the same inputs differs")
                caught = {which: f > tol for which, f in faults.items()}
                note = (f"{tag} {case} b=2 h={h} d={d}: max_abs_err {err:.3g} (tol {tol} * "
                        f"(1 + |plain|)), second call bit-identical; planted faults (plain with "
                        f"head columns {d // 2}-{d - 1} zeroed) " + ", ".join(
                            f"{which} {f:.3g} ({'caught' if caught[which] else 'MISSED'})"
                            for which, f in faults.items()))
                if not all(caught.values()):
                    log(note)
                    raise AssertionError(f"{case}: a planted fault passes the check: {faults}")
                if n != timed_n:
                    log(note)
                    continue
                ms = cuda_median_ms(lambda: sa.serving_attention(q, k, v, lens, rope))
                with tf32(False):
                    plain_ms = cuda_median_ms(
                        lambda: sa.serving_attention_reference(q, k, v, lens, rope),
                        iters=5, warmup=1)
                    vt = v.transpose(1, 2)
                    if rope is None:
                        qt, kt = q.transpose(1, 2), k.transpose(1, 2)

                        def operands():
                            return qt, kt
                    else:
                        def operands():
                            return rotated_outside(q, rope), rotated_outside(k, rope)
                    if dtype == torch.bfloat16:
                        def library():
                            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                                return F.scaled_dot_product_attention(*operands(), vt)
                    else:
                        key_mask = (torch.arange(n, device=dev)[None]
                                    < lens[:, None])[:, None, None, :]

                        def library():
                            return F.scaled_dot_product_attention(*operands(), vt,
                                                                  attn_mask=key_mask)
                    library_ms = cuda_median_ms(library)
                work = attention_work(2, n, h, d, list(lens_list), with_rope, q.element_size())
                least = bound(*work, "bf16" if dtype == torch.bfloat16 else "tf32x3")
                log(f"{note}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{least['bound_ms']:.5f} ms by {least['bound_by']} "
                    f"({100 * least['bound_ms'] / ms:.1f} % of it), library "
                    f"(scaled_dot_product_attention"
                    + (", flash backend, no key mask" if dtype == torch.bfloat16
                       else ", boolean key mask, TF32 off")
                    + (", q and k rotated outside it" if rope is not None else "")
                    + f") {library_ms:.4f} ms: the kernel takes {ms / library_ms:.2f}x its time")
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, **least)
            del q, k, v, want, got
    return rows


def check_keep_bits_at(dev, tag: str, h: int, d: int, dtypes) -> None:
    """The keep bits kernels 4a and 4c regenerate at head dim ``d``, bit for
    bit against `dropout_keep_mask`, in each of ``dtypes``: with q = k = 0
    every weight of a [128, 128] head is 1 / 128, and with V = dO = I the
    forward's O[i, c] is Pd[i, c] and dk/dv's dV[j, c] is Pd[c, j], each 0
    exactly where the bit drops (i, j) and non-zero where it keeps it."""
    import torch

    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    n, rate, seed = KEEP_N, 0.1, 0x5EED0000 + d
    want = torch.stack([torch.stack([ta.dropout_keep_mask(seed, bi, hi, 0, 0, n, n, n,
                                                          1.0 - rate, dev)
                                     for hi in range(h)]) for bi in range(2)])
    for dtype in dtypes:
        zeros = torch.zeros((2, n, h, d), dtype=dtype, device=dev)
        eye = torch.eye(n, d, dtype=dtype, device=dev)[None, :, None, :].expand(2, n, h, d)
        eye = eye.contiguous()
        lens = torch.full((2,), n, dtype=torch.int32, device=dev)
        fwd, _, dkv = ta._LAUNCHERS[dtype]
        out, lse = fwd(zeros, zeros, eye, lens, rate, seed)
        _, dv = dkv(zeros, zeros, eye, lens, lse, ta.row_dot(eye, out), eye, rate, seed)
        got = {"4a (O)": out.permute(0, 2, 1, 3)[..., :n] != 0,
               "4c (dV)": dv.permute(0, 2, 3, 1)[:, :, :n] != 0}
        wrong = {name: int((bits != want).sum()) for name, bits in got.items()}
        log(f"{tag} keep bits {str(dtype).split('.')[-1]} b=2 h={h} n={n} d={d} dropout {rate}: "
            f"{int(want.sum())} of {want.numel()} kept; bits that differ from "
            f"dropout_keep_mask: {wrong}; planted fault (the next seed's mask): "
            + str(int((ta.dropout_keep_mask(seed + 1, 0, 0, 0, 0, n, n, n, 1.0 - rate, dev)
                       != want[0, 0]).sum())) + " bits of head (0, 0) differ")
        if any(wrong.values()):
            raise AssertionError(f"{tag} the kernels' keep bits differ: {wrong}")


def check_train_attention_at(dev, tag: str, h: int, d: int, seed: int, cases, dtypes,
                             fault_rates) -> dict:
    """Kernels 4a / 4b / 4c at head dim ``d`` (b = 2, ``h`` heads) in each of
    ``dtypes`` through `train_attention`'s autograd against the plain
    version on ``cases`` ((n, lens) each), dropout 0.1 and keep = 1: bf16
    within TOL and ATTN_REL_TOL with the wrong-seed control
    (:func:`check_train_attention_case`), fp32 within FP32_ATTN_TOLS with a
    TF32 control at dropout 0.1 (:func:`check_train_attention_fp32_case`);
    the LSE; second calls bit-identical. At the first case's n and each rate
    of ``fault_rates`` a planted fault, the plain version with the second
    half of V's head columns zeroed, must be refused; then the kernels are
    timed (:func:`time_train_attention`). Returns the JSON rows of that n,
    ``train_attention[_fp32]_<tag>_*``."""
    import torch

    rows, label = {}, tag.strip("[]")
    for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        if dtype not in dtypes:
            continue
        gen = torch.Generator(device=dev).manual_seed(seed + len(dname))
        errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        times = None
        for n, lens_list in cases:
            q, k, v, dout = (torch.randn((2, n, h, d), generator=gen, device=dev).to(dtype)
                             for _ in range(4))
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            seed_n = 0x5EED0000 + n + d
            for rate in (0.1, 0.0):
                case = f"train_attention {dname} b=2 h={h} d={d} n={n} lens={list(lens_list)} " \
                       f"dropout {rate}"
                if dtype == torch.bfloat16:
                    abs_err = check_train_attention_case(q, k, v, dout, lens, rate,
                                                         seed_n)["abs_err"]
                    got = [abs_err[name] for name in ("fwd", "dq", "dk", "dv")]
                else:
                    err, out, want, lse_err = check_train_attention_fp32_case(
                        q, k, v, dout, lens, rate, seed_n, case)
                    got = [float((g - w).abs().max()) for g, w in zip(out, want)]
                    note = ""
                    if rate > 0.0:
                        control = tf32_control(q, k, v, dout, lens, rate, seed_n, want, case)
                        note = "; TF32 control (refused) " + ", ".join(
                            f"{name} {c:.3g}" for name, c in control.items())
                    del out, want
                    log(f"{tag} {case}: " + ", ".join(f"{name} {e:.3g}"
                                                      for name, e in err.items())
                        + f" (limits {FP32_ATTN_TOLS}); LSE relative L2 {lse_err:.3g}; second "
                        f"forward and backward bit-identical{note}")
                for name, e in zip(("fwd", "dq", "dkv", "dkv"), got):
                    errs[name] = max(errs[name], e)
            if n != cases[0][0]:
                del q, k, v, dout
                continue
            for rate in fault_rates:
                with tf32(False):
                    want = plain_attention_grads(q, k, v, dout, lens, rate, seed_n)
                    bad = plain_attention_grads(q, k, zero_upper_half(v), dout, lens, rate,
                                                seed_n)
                if dtype == torch.bfloat16:
                    fault = {name: rel_l2(b, w) for name, b, w in zip(("fwd", "dq", "dk", "dv"),
                                                                     bad, want)}
                    caught = any(f > ATTN_REL_TOL for f in fault.values())
                    limits = f"relative L2, tol {ATTN_REL_TOL}"
                else:
                    fault = fp32_attention_errors(bad, want)
                    caught = any(fault[name] > tol for name, tol in FP32_ATTN_TOLS.items())
                    limits = f"limits {FP32_ATTN_TOLS}"
                del want, bad
                log(f"{tag} train_attention {dname} n={n} dropout {rate}, planted fault (plain "
                    f"with V's head columns {d // 2}-{d - 1} zeroed): "
                    + ", ".join(f"{name} {f:.3g}" for name, f in fault.items())
                    + f" ({limits}): {'caught' if caught else 'MISSED'}")
                if not caught:
                    raise AssertionError(f"{tag} train_attention {dname}: the planted fault "
                                         "passes")
            ms, times, least, ffma = time_train_attention(q, k, v, dout, lens, list(lens_list),
                                                          seed_n)
            plain_fwd, plain_bwd, lib_fwd, lib_bwd = train_attention_yardsticks(times)
            keep1 = ms[0.0]
            log(f"{tag} train_attention {dname} b=2 n={n} h={h} d={d} lens {list(lens_list)}: "
                f"at dropout 0.1 forward {ms[0.1]['fwd']:.4f} ms, dq {ms[0.1]['dq']:.4f} ms, "
                f"dk/dv {ms[0.1]['dkv']:.4f} ms; at keep = 1 forward {keep1['fwd']:.4f} ms, dq "
                f"{keep1['dq']:.4f} ms, dk/dv {keep1['dkv']:.4f} ms; bounds "
                + ", ".join(f"{name} {x['bound_ms']:.5f} ms by {x['bound_by']} "
                            f"({x['bound_ms'] / keep1[name]:.1%} of keep 1)"
                            for name, x in least.items())
                + (" at the 3xTF32 rate (FFMA " + " / ".join(
                    f"{x['bound_ms']:.5f}" for x in ffma.values()) + " ms)"
                   if dtype == torch.float32 else "")
                + f"; plain forward {plain_fwd:.4f} ms, plain backward {plain_bwd:.4f} ms; "
                f"library scaled_dot_product_attention{' (TF32 off)' if dname == 'fp32' else ''} "
                f"at keep = 1, no mask, backend {sdpa_backend(q, k, v)}: forward {lib_fwd:.4f} "
                f"ms, backward {lib_bwd:.4f} ms; "
                f"against it at keep = 1 the forward takes {keep1['fwd'] / lib_fwd:.2f}x and "
                f"dq + dk/dv {(keep1['dq'] + keep1['dkv']) / lib_bwd:.2f}x its time")
            del q, k, v, dout
        prefix = f"train_attention_{label}" if dname == "bf16" else f"train_attention_fp32_{label}"
        rows.update({f"{prefix}_{name}": dict(max_abs_err=errs[name], **times[name])
                     for name in errs})
    return rows


def head_dim_counters() -> dict:
    """Every attention launcher's counters by head dim (the dicts themselves)."""
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    counters = {"serving_attention": sa.serving_attention.launches_by_head_dim,
                "serving_attention_fp32": sa.serving_attention.launches_fp32_by_head_dim}
    for fn in (ta.flash_forward, ta.flash_dq, ta.flash_dkv, ta.flash_forward_fp32,
               ta.flash_dq_fp32, ta.flash_dkv_fp32):
        counters[fn.__name__] = fn.launches_by_head_dim
    return counters


def head_dim_counts() -> dict:
    """Every attention launcher's launches by head dim, copied, and the plain
    attention's calls on the card (under ``"plain_attention"``)."""
    from eraxvif5tts_tpu_torch.ops.attention import plain_attention

    counts = {name: dict(counts) for name, counts in head_dim_counters().items()}
    counts["plain_attention"] = {"calls": plain_attention.calls}
    return counts


def reset_head_dim_counts() -> None:
    from eraxvif5tts_tpu_torch.ops.attention import plain_attention

    for counts in head_dim_counters().values():
        for d in counts:
            counts[d] = 0
    plain_attention.calls = 0


def launched_at(name: str, d: int, count: int) -> dict:
    """The head-dim counters of ``name`` with ``count`` launches at ``d`` alone."""
    from eraxvif5tts_tpu_torch.ops.train_attention import KERNEL_HEAD_DIMS

    return {name: {dim: count if dim == d else 0 for dim in KERNEL_HEAD_DIMS}}


def serve_at(cfg, ckpt: Path, dev, dtype: str | None, tag: str, texts) -> int:
    """The checkpoint of ``cfg`` (heads x dim_head, full width) served by
    `F5TTSWrapper(model_cfg=cfg)`, bf16 when asked, else default-built
    (fp32): the backbone against its plain versions (bf16, DIT_TOL) or the
    CPU's (fp32), then `generate` of ``texts`` at NFE 32, each chunk one
    graph replay with kernel 1 counted depth x 32 a chunk (kernel 2 as well
    in bf16), rotary fused where the head dim takes it (d = 64, 128) and
    without it at d = 256 (q and k rotated outside, as the JAX models do):
    every attention launch of this head dim's instantiation, none of
    another, and no plain attention on the card. Returns kernel 1's
    launches."""
    import torch

    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.ops.attention import rotary_fused

    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    t0 = time.perf_counter()
    extra = {} if dtype is None else {"compute_dtype": dtype}
    wrapper = F5TTSWrapper(model_cfg=cfg, ckpt_path=str(ckpt), vocab_char_map=vocab,
                           device=dev, nfe_step=NFE, **extra)
    randomize((wrapper.vocoder,), SEED)
    torch.cuda.synchronize()
    a = wrapper.config.arch
    tag = f"{tag} {wrapper.compute_dtype}"
    log(f"{tag} F5TTSWrapper(model_cfg=<the YAML's>, "
        f"{'compute_dtype=' + repr(dtype) if dtype else 'no compute_dtype'}): dim {a.dim} depth "
        f"{a.depth} heads {a.heads}x{a.dim_head} ff_mult {a.ff_mult}, "
        f"{sum(p.numel() for p in wrapper.transformer.parameters()) / 1e6:.1f} M DiT params, "
        f"{wrapper.compute_dtype}, built in {time.perf_counter() - t0:.1f} s")
    if dtype is None:
        if wrapper.compute_dtype != "float32":
            raise AssertionError(f"{tag} the default wrapper serves {wrapper.compute_dtype}")
        check_backbone_against_cpu(wrapper.transformer, dev, tag)
        counter = "serving_attention_fp32"
    else:
        check_dit_against_plain(wrapper.transformer, dev, tag)
        counter = "serving_attention"
    path = counter + ("" if rotary_fused(a.dim_head) else "_norope")
    ref = load_reference(wrapper)
    reset_head_dim_counts()
    # bf16 runs the normalised projection (kernel 2) too, as the main phase
    counts = generate_counted(wrapper, ref, texts, NFE, tag,
                              (path, "ln_mod_matmul") if dtype else (path,))
    by_d = head_dim_counts()
    want = launched_at(counter, a.dim_head, counts[path])
    if {counter: by_d[counter]} != want or any(
            sum(c.values()) for name, c in by_d.items() if name != counter):
        raise AssertionError(f"{tag} launches by head dim {by_d}, expected {want} alone")
    log(f"{tag} launches by head dim: {by_d[counter]} (d = {a.dim_head} only; no plain "
        "attention on the card)")
    return counts[path]


@contextlib.contextmanager
def lost_tile_attention():
    """The plain training attention with the last 64-key tile of every
    sample masked inside the block (what a kernel that lost one tile would
    give): the control of a dropout-free check, where wrong dropout keys
    change nothing."""
    import torch

    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    reference = ta.train_attention_reference

    def short_of_a_tile(q, k, v, lens=None, *args, **kwargs):
        full = torch.full((q.shape[0],), q.shape[1], device=q.device)
        lens = full if lens is None else lens
        return reference(q, k, v, torch.clamp(lens, max=q.shape[1] - 64), *args, **kwargs)

    ta.train_attention_reference = short_of_a_tile
    try:
        yield
    finally:
        ta.train_attention_reference = reference


def train_at(dev, arch, tag: str, variants, rounding: tuple = ()) -> dict:
    """CFM training of the heads x dim_head DiT of ``arch`` at full width and
    depth (blocks checkpointed, remat full), one run per variant ``(compute
    dtype or None for fp32, its name, dropout, limits, control)``: `CFM.loss`
    at b = 2, n = 1024 (:func:`loss_batch`) with the kernels against the
    plain attention (:func:`hold_loss_against_plain`, the control wrong
    attention-dropout keys at dropout > 0, a lost key tile at dropout 0;
    the readings in ``rounding`` held within bf16 rounding alone),
    then `Trainer.train_step` at STEP, a warm-up and one timed step, with
    the step's dtype's kernels counted 2 x depth / depth / depth a step at
    this head dim and none at another or of the other dtype, and no plain
    attention on the card; each step's wall and the peak memory logged.
    Returns the launches of the timed steps, summed over the variants."""
    import torch

    from eraxvif5tts_tpu_torch.models.cfm import CFM
    from eraxvif5tts_tpu_torch.models.dit import DiT
    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.training.trainer import Trainer, batch_seed, make_optimizer

    b, n = STEP
    d, label = arch.dim_head, tag.strip("[]")
    depth = arch.depth
    launches = {}
    for dtype, dname, rate, tols, control in variants:
        run_arch = dataclasses.replace(arch, dropout=rate, checkpoint_activations=True,
                                       remat_policy="full")
        t0 = time.perf_counter()
        dit = DiT(run_arch, text_num_embeds=len(VOCAB_CHARS), mel_dim=100,
                  compute_dtype=dtype).to(dev)
        randomize((dit,), SEED)
        cfm = CFM(dit.train())
        log(f"{tag} train {dname}: DiT dim {arch.dim} depth {depth} heads {arch.heads}x"
            f"{arch.dim_head}, {sum(p.numel() for p in dit.parameters()) / 1e6:.1f} M fp32 "
            f"parameters, {dname} compute, dropout {rate}, remat {run_arch.remat_policy}, built "
            f"in {time.perf_counter() - t0:.1f} s")
        # at the train phase's n = 1024, where its limits were set: at 4096 the
        # loss of 2 x 4096 frames averages a wrong mask away (2.7e-6 beside
        # 7.9e-6 of bf16 rounding on an H100, 8 x 128 heads)
        mel, text, lens, draws = loss_batch(dev, SEED + 180, depth)
        hold_loss_against_plain(f"{tag} train {dname} CFM.loss b=2 n={mel.shape[1]} dropout "
                                f"{rate}", dit,
                                lambda draws: cfm.loss(mel, text, lens, draws)[0], draws, tols,
                                control=control, rounding=rounding)
        del mel, text, lens, draws
        trainer = Trainer(cfm=cfm, optimizer=make_optimizer(num_warmup_updates=1,
                                                             total_updates=1000))
        state = trainer.init_state()
        step_dtype = torch.bfloat16 if dtype is not None else torch.float32
        kernels = ta._LAUNCHERS[step_dtype]
        reset_head_dim_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for i in range(2):  # a warm-up, then the timed step
            batch = train_batch(dev, SEED + 190 + i, (b, n))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(
                state, batch, torch.Generator(device=dev).manual_seed(batch_seed(SEED, 0, i)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if not (math.isfinite(metrics["loss"]) and metrics["applied"] == 1.0):
                raise AssertionError(f"{tag} train {dname} step {i + 1}: {metrics}")
        by_d = head_dim_counts()
        # the forward twice a step (the blocks are checkpointed), dq and dk/dv once
        want = {}
        for fn in kernels:
            want.update(launched_at(fn.__name__, d,
                                    len(walls) * depth * (2 if fn is kernels[0] else 1)))
        others = {name: c for name, c in by_d.items()
                  if name not in want and sum(c.values())}
        if {name: by_d[name] for name in want} != want or others:
            raise AssertionError(f"{tag} train {dname}: launches by head dim {by_d}, expected "
                                 f"{want} alone")
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"{tag} train {dname} dropout {rate} Trainer.train_step b={b} n={n}: warm-up "
            f"{walls[0]:.3f} s, timed step {walls[1]:.3f} s ({b * n / walls[1]:.0f} frames/s), "
            f"loss {metrics['loss']:.5f}, peak memory {peak / 2**30:.2f} GiB; launches by head "
            "dim " + ", ".join(f"{name} {by_d[name]}" for name in want))
        prefix = f"train_attention_{label}" if dname == "bf16" else f"train_attention_fp32_{label}"
        for name, fn in zip(("fwd", "dq", "dkv"), kernels):
            key = f"{prefix}_{name}"
            launches[key] = launches.get(key, 0) + by_d[fn.__name__][d]
        del trainer, state, cfm, dit
        torch.cuda.empty_cache()
    return launches


# ---- [d128]: head dim 128 in kernels 1 and 4 --------------------------------
# F5TTS_v1_Base at its full width (inner 1024) and depth as 8 heads of 128: the
# YAML's `model.arch.dim_head`, which reaches the model through the config
# loader in both packages; the JAX package runs its Pallas kernels there.
D128_HEADS, D128_DIM_HEAD = 8, 128
D128_SERVE = (1088, (1051, 0))  # kernel 1 at the DiT's serving bucket, a sample with no valid key
# kernel 4's cases; at n = 1088 (an odd multiple of 64) the forward's last
# 128-key tile hangs 64 keys over n, beside a sample with no valid key
D128_TRAIN = ((4096, (4096, 4059)), (1088, (1051, 0)), (JOINT_N, (JOINT_N, JOINT_N - 37)))
STEP = (2, 4096)  # the CFM steps of [d128] and [d256]: b, n
KEEP_N = 128  # the keep-bit readout's sequence: one [128, 128] head of bits
# CFM.loss of the 8 x 128 DiT at b = 2, n = 1024, kernels vs plain attention, by
# the rule above (H100, 700 W): bf16 gradient L2 3.4e-3 vs 6.3e-3, past
# GRAD_TOL, which was set on 16 x 64 heads (the kernels' own errors are d =
# 64's: relative L2 3.2e-3 / 2.6e-3 at both head dims); its q / k / v gradient
# 2.9e-3 vs 1.8e-2 keeps QKV_GRAD_TOL. The bf16 loss at dropout 0.1 over ten
# loss batches (seeds SEED + 180 on; `tools/probe_train_attention.py
# --loss-seeds 10`, these kernels and the ones before them) moved 1.9e-6 to
# 1.74e-5 at d = 128 and 1e-7 to 1.94e-5 at d = 256 by bf16 rounding alone,
# while wrong attention-dropout keys moved it 9.8e-7 to 3.9e-5 and 1.9e-6 to
# 2.1e-5: no limit on the loss can see wrong keys, so it is held within bf16
# rounding (1.5x the largest sound reading) and its control logged; the
# gradients (2.6e-3 to 3.4e-3 vs 4.8e-3 to 6.3e-3 and, q / k / v, 1.7e-2 to
# 2.1e-2) hold the masks
D128_LOSS_TOL = 3e-5
D128_GRAD_TOL = 4.6e-3
# fp32: the 3xTF32 kernels give the plain version's loss (relative error 0 on
# an H100), and wrong attention-dropout keys move it by 9.9e-7, which
# FP32_STEP_LOSS_TOL could not see: a tenth of the control; the gradients
# (2.7e-7 and 3.8e-7 vs 3.8e-3 and 1.8e-2) keep FP32_STEP_GRAD_TOL
D128_FP32_LOSS_TOL = 1e-7


def phase_d128(dev) -> tuple[dict, dict]:
    """Head dim 128 in kernels 1 and 4: the built geometry and the refusal of
    another d (:func:`check_d128_geometry`), each kernel mode against its
    plain version with its planted faults and timed (kernel 1:
    :func:`check_serving_attention_at`, with and without rotary; 4a-4c:
    :func:`check_train_attention_at`; the keep bits:
    :func:`check_keep_bits_at`), in bf16 and fp32; F5TTS_v1_Base.yaml with
    8 heads of 128 (:func:`head_dim_config`) as a seeded N(0, 0.02)
    reference-format checkpoint served in bf16 and in fp32 (:func:`serve_at`,
    one text each) and trained in both at dropout 0.1 (:func:`train_at`).
    Returns (the JSON rows, the launches on the path)."""
    import torch

    tag, h, d = "[d128]", D128_HEADS, D128_DIM_HEAD
    check_d128_geometry()
    log_forward_build(tag, d)
    rows = check_serving_attention_at(
        dev, tag, h, d, SEED + 160, ((*D128_SERVE, (True, False)), (JOINT_N, JOINT_LENS, (False,))))
    rows.update(check_train_attention_at(dev, tag, h, d, SEED + 170, D128_TRAIN,
                                         (torch.bfloat16, torch.float32), (0.1,)))
    check_keep_bits_at(dev, tag, h, d, (torch.bfloat16, torch.float32))
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg, path = head_dim_config(Path(tmp), h, d, tag)
        log(f"{tag} {path.name}: configs/F5TTS_v1_Base.yaml with model.arch heads {h}, "
            f"dim_head {d}, loaded by load_model_config: {cfg.arch}")
        ckpt = Path(tmp) / "model.pt"
        save_reference_checkpoint(ckpt, cfg, dev)
        # one text a dtype: the whole smoke passed 850 s on a slow host
        launches["serving_attention_d128"] = serve_at(cfg, ckpt, dev, "bfloat16", tag, TEXTS[:1])
        launches["serving_attention_fp32_d128"] = serve_at(cfg, ckpt, dev, None, tag, TEXTS[:1])
    launches.update(train_at(dev, cfg.arch, tag, (
        (torch.bfloat16, "bf16", 0.1, {"loss": D128_LOSS_TOL, "gradient L2": D128_GRAD_TOL,
                                       "q/k/v gradient L2": QKV_GRAD_TOL}, "keys"),),
        rounding=("loss",)))
    launches.update(train_at(dev, cfg.arch, tag, (
        (None, "fp32", 0.1, {"loss": D128_FP32_LOSS_TOL, "gradient L2": FP32_STEP_GRAD_TOL,
                             "q/k/v gradient L2": FP32_STEP_GRAD_TOL}, "keys"),)))
    return rows, launches


# ---- [d256]: head dim 256, kernel 6's roles -----------------------------------
# F5TTS_v1_Base at its full width and depth as 4 heads of 256. The JAX package
# runs its library flash kernel (kernel 6, `eraxvif5tts_tpu/ops/attention.py:38`)
# there: serving with q and k rotated outside it (its serving kernel refuses d =
# 256), and dropout-free training through its forward and backward. The port's
# d = 256 kernels: the forward (serving and the training forward), dq and dk/dv,
# each in bf16 and fp32.
D256_HEADS, D256_DIM_HEAD = 4, 256
D256_SERVE = ((1088, (1051, 0), (False,)), (JOINT_N, JOINT_LENS, (False,)))
D256_TRAIN = ((4096, (4096, 4059)), (1088, (1051, 0)), (JOINT_N, (JOINT_N, JOINT_N - 37)))
# CFM.loss of the 4 x 256 DiT at b = 2, n = 1024, kernels vs plain attention
# (H100, 700 W): at dropout 0 against a lost key tile,
# gradient L2 3.3e-3 vs 1.6e-2, q / k / v 2.7e-3 vs 6.7e-2; at dropout 0.1
# against wrong keys 3.4e-3 vs 6.3e-3 and 2.9e-3 vs 1.8e-2: D128_GRAD_TOL and
# QKV_GRAD_TOL lie between. The loss moved 5.0e-6 (dropout 0) and 8.9e-7
# (0.1) where the controls moved it 4.0e-6 and 7.2e-6: bf16 rounding of the
# loss is the size of a control (over ten seeds: as at d = 128, above), so
# the loss is held within D128_LOSS_TOL (bf16 rounding) and its control
# logged, as the MMDiT's step holds it
D256_TOLS = {"loss": D128_LOSS_TOL, "gradient L2": D128_GRAD_TOL,
             "q/k/v gradient L2": QKV_GRAD_TOL}
# fp32: the d = 128 fp32 limits (the 3xTF32 kernels against plain attention)
D256_FP32_TOLS = {"loss": D128_FP32_LOSS_TOL, "gradient L2": FP32_STEP_GRAD_TOL,
                  "q/k/v gradient L2": FP32_STEP_GRAD_TOL}


def check_d256_geometry() -> None:
    """The constants the d = 256 instantiations report against the ones
    `ops/train_attention.py` states (the bf16 forward, the backward, the
    fp32 forward core, the fp32 dq and dk/dv), and the C interface refusing
    fused rotary at 256 (non-zero codes, no kernel runs)."""
    import ctypes

    import torch

    from eraxvif5tts_tpu_torch.ops import _cuda
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    d, built_keys = D256_DIM_HEAD, ("rows", "stages", "threads", "shared_bytes")
    fwd, bwd = ta.forward_geometry(2, 4096, 4, d), ta.backward_geometry(2, 4096, 4, d)
    f32, b32 = sa.forward_geometry_fp32(2, 4096, 4, d), ta.backward_geometry_fp32(2, 4096, 4, d)
    stated = {"forward": {key: fwd[key] for key in ta.FORWARD_BUILT},
              "backward": {key: bwd[key] for key in built_keys},
              "fp32 serving": {key: f32[key] for key in ta.FP32_FORWARD_BUILT},
              "fp32 training": dict({key: f32[key] for key in ta.FP32_FORWARD_BUILT},
                                    **fp32_backward_stated(b32))}
    built = {"forward": ta.kernel_forward_geometry(d), "backward": ta.kernel_backward_geometry(d),
             "fp32 serving": sa.kernel_geometry_fp32(d),
             "fp32 training": ta.kernel_geometry_fp32(d)}
    if built != stated:
        raise AssertionError(f"[d256] built geometry: {built}; stated {stated}")
    log(f"[d256] built geometry equals the stated one: bf16 forward {built['forward']} "
        f"(registers {fwd['registers']}, {'overlapped' if fwd['overlap'] else 'serial'} "
        f"products), backward {built['backward']} (columns "
        f"{bwd['columns']}); fp32 serving {built['fp32 serving']} ({f32['sets']} warp sets "
        f"of four, key tiles of {f32['key_tile']}, Q split at each use); fp32 training "
        f"{built['fp32 training']} (dq and dk/dv in pairs of warps, {b32['dq_tile']}-row "
        f"tiles split once; dq warps (first row, first column, columns) {b32['dq_warps']}, "
        f"a raw room of {b32['dq_raw_bytes']} bytes; dk/dv warps (first key, output) "
        f"{b32['dkv_warps']}, P slots of {b32['p_slot_bytes']} bytes)")
    lib = _cuda.kernels().lib
    q = torch.zeros((1, 64, 2, d), dtype=torch.float32, device="cuda")
    qb = q.bfloat16()
    lens = torch.full((1,), 64, dtype=torch.int32, device="cuda")
    stream = _cuda.stream_ptr(q.device)
    refused = {}
    for name, t in (("erax_serving_attention", qb), ("erax_serving_attention_fp32", q)):
        refused[f"{name} roped"] = getattr(lib, name)(
            t.data_ptr(), t.data_ptr(), t.data_ptr(), lens.data_ptr(), q.data_ptr(),
            q.data_ptr(), t.data_ptr(), 1, 64, 2, d, 1, 1.0, stream)
    torch.cuda.synchronize()
    if not all(refused.values()):
        raise AssertionError(f"[d256] an entry point took what is not built at 256: {refused}")
    log(f"[d256] fused rotary at d = 256 refused by the C interface (non-zero codes, no "
        f"launch): {refused}")


def phase_d256(dev) -> tuple[dict, dict]:
    """Head dim 256 in kernel 6's roles: the built geometry and the refusals
    (:func:`check_d256_geometry`), each d = 256 kernel against its plain
    version with its planted faults and timed (the serving forward without
    rotary and the training kernels at dropout 0.1 and keep = 1, the keep
    bits, each in bf16 and fp32), F5TTS_v1_Base.yaml with 4 heads of 256 as
    a seeded N(0, 0.02) reference-format checkpoint served in bf16 and in
    fp32 (one text each) and trained in both at dropout 0 and 0.1. Returns
    (the JSON rows, the launches on the path)."""
    import torch

    tag, h, d = "[d256]", D256_HEADS, D256_DIM_HEAD
    check_d256_geometry()
    log_forward_build(tag, d)
    rows = check_serving_attention_at(dev, tag, h, d, SEED + 260, D256_SERVE)
    rows.update(check_train_attention_at(dev, tag, h, d, SEED + 270, D256_TRAIN,
                                         (torch.bfloat16, torch.float32), (0.1, 0.0)))
    check_keep_bits_at(dev, tag, h, d, (torch.bfloat16, torch.float32))
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg, path = head_dim_config(Path(tmp), h, d, tag)
        log(f"{tag} {path.name}: configs/F5TTS_v1_Base.yaml with model.arch heads {h}, "
            f"dim_head {d}, loaded by load_model_config: {cfg.arch}")
        ckpt = Path(tmp) / "model.pt"
        save_reference_checkpoint(ckpt, cfg, dev)
        launches["serving_attention_d256_norope"] = serve_at(cfg, ckpt, dev, "bfloat16", tag,
                                                             TEXTS[:1])
        launches["serving_attention_fp32_d256_norope"] = serve_at(cfg, ckpt, dev, None, tag,
                                                                  TEXTS[:1])
    launches.update(train_at(dev, cfg.arch, tag, tuple(
        (torch.bfloat16, "bf16", rate, D256_TOLS, "keys" if rate > 0.0 else "tile")
        for rate in (0.0, 0.1)), rounding=("loss",)))
    launches.update(train_at(dev, cfg.arch, tag, tuple(
        (None, "fp32", rate, D256_FP32_TOLS, "keys" if rate > 0.0 else "tile")
        for rate in (0.0, 0.1))))
    return rows, launches


COMPRESS_DEPTHS = (14, 12)  # F5TTS_v1_Pruned_14 / _12
COMPRESS_SERVE = ((14, 7), (14, 16), (12, 16))  # (depth, NFE) of the served students


def prune_with_cli(teacher: Path, tmp: Path, blocks: int) -> dict:
    """`python -m eraxvif5tts_tpu_torch.compression prune` of the teacher to
    each depth of COMPRESS_DEPTHS, the processes run side by side (each
    re-loads its result into the port's DiT, strict); then each report (the
    teacher's ``blocks``, the first and last two kept) and the strict load
    once more here. Returns {depth: pruned checkpoint}."""
    from eraxvif5tts_tpu_torch.compression.pruner import test_pruned_model

    t0 = time.perf_counter()
    procs, out = {}, {}
    try:
        for depth in COMPRESS_DEPTHS:
            out[depth] = tmp / f"pruned_{depth}.pt"
            procs[depth] = subprocess.Popen(
                [sys.executable, "-m", "eraxvif5tts_tpu_torch.compression", "prune",
                 str(teacher), str(out[depth]), "--target-layers", str(depth)],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for depth, proc in procs.items():
            text, _ = proc.communicate(timeout=600)
            for line in text.strip().splitlines():
                log(f"[compress] prune {depth}: {line}")
            if proc.returncode != 0:
                raise AssertionError(f"prune to {depth} blocks exited {proc.returncode}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for depth, path in out.items():
        report = json.loads(Path(str(path) + ".prune_report.json").read_text())
        keep = report["blocks_to_keep"]
        ends = sorted({0, 1, blocks - 2, blocks - 1})[:depth]
        if (len(keep) != depth or report["original_num_transformer_blocks"] != blocks
                or not set(ends) <= set(keep) or not test_pruned_model(str(path))):
            raise AssertionError(f"pruned checkpoint {path.name}: report {report}")
        log(f"[compress] {path.name}: {path.stat().st_size / 2**30:.2f} GiB, blocks {keep} "
            f"(fallback {report['used_fallback']}), params {report['params_before']:,} -> "
            f"{report['params_after']:,}; loads strict into the port's DiT")
    log(f"[compress] both prunes (two processes side by side) in {wall:.1f} s")
    return out


def alignment(lens, text, frames: int):
    """A monotonic alignment ``[b, nt, frames]`` for a batch: the valid frames
    of each sample split evenly over its valid text tokens."""
    import torch

    nt = text.shape[1]
    text_lens = (text != -1).sum(-1)
    frame = torch.arange(frames, device=text.device)
    token = frame[None, :] * text_lens[:, None] // lens[:, None]  # [b, frames]
    valid = frame[None, :] < lens[:, None]
    one_hot = token[:, None, :] == torch.arange(nt, device=text.device)[None, :, None]
    return (one_hot & valid[:, None, :]).float()


def check_teacher_against_plain(teacher, dev) -> None:
    """The teacher's eval forward as a distillation step gives it: B x n =
    TRAIN_BATCH (kernel 1 with rotary at lens=None and kernel 2 on 36,864
    rows in one launch a block) against the plain serving ops on the same
    inputs, within DIT_TOL of the plain output's scale. The plain version runs
    three samples at a time (its attention materialises [b, 16, n, n] fp32
    logits; without lengths the samples are independent)."""
    import torch

    b, n = TRAIN_BATCH
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    mel = torch.randn((b, n, 100), generator=g, device=dev)
    x0 = torch.randn((b, n, 100), generator=g, device=dev)
    time_ = torch.rand((b,), generator=g, device=dev)
    xt = (1 - time_[:, None, None]) * x0 + time_[:, None, None] * mel
    cond = mel.masked_fill((torch.arange(n, device=dev) >= n // 4)[None, :, None], 0.0)
    text = torch.randint(0, len(VOCAB_CHARS), (b, TRAIN_TEXT), generator=g, device=dev)
    text[1::2, TRAIN_TEXT // 2:] = -1
    no_drop = torch.zeros(b, dtype=torch.bool, device=dev)
    with torch.no_grad():
        got = teacher(xt, cond, text, time_, no_drop, no_drop).float()
        with plain_serving_ops():
            want = torch.cat([teacher(xt[i:i + 3], cond[i:i + 3], text[i:i + 3], time_[i:i + 3],
                                      no_drop[i:i + 3], no_drop[i:i + 3]).float()
                              for i in range(0, b, 3)])
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"[compress] teacher (eval, lens=None) b={b} n={n}, kernels 1 + 2 vs plain: max error "
        f"{rel:.3g} of scale {float(want.abs().max()):.3g} (tol {DIT_TOL})")
    if not torch.isfinite(got).all() or rel > DIT_TOL:
        raise AssertionError(f"the teacher with kernels differs from plain by {rel:.3g}")


def check_distill_against_plain(trainer, state, dev) -> None:
    """The distillation loss of a b = 2, n = 1024 batch on the card with the
    student's training kernels against `train_attention.plain` on the same
    draws and dropout keys (:func:`hold_loss_against_plain`): its gradients
    held to the train phase's limits and control, the loss logged (see
    LOSS_TOL)."""
    from eraxvif5tts_tpu_torch.training.distill import distillation_losses

    student, teacher = state.model, trainer.teacher_transformer
    mel, text, lens, draws = loss_batch(dev, SEED + 5, len(student.transformer_blocks),
                                        trainer.config.frac_lengths_mask)
    hold_loss_against_plain(
        "[compress] distillation loss b=2 n=1024 (the student's training kernels)", student,
        lambda draws: distillation_losses(trainer.student_cfm, teacher, mel, text, lens, draws,
                                          trainer.config)[0],
        draws, {"gradient L2": GRAD_TOL, "q/k/v gradient L2": QKV_GRAD_TOL})


def distill_counts() -> list:
    """The launches of the distillation step's kernels: 1 (rotary), 2
    (layernorm), 4a, 4b, 4c."""
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    counts = serving_counts()
    return [counts["serving_attention"], counts["ln_mod_matmul"], ta.flash_forward.launches,
            ta.flash_dq.launches, ta.flash_dkv.launches]


def phase_compress(dev) -> dict:
    """The compression path at F5TTS_v1_Base width: prune a random
    22-block checkpoint to 14 and 12 blocks with the port's CLI, distill the
    teacher into the 14-block student with the duration predictor trained
    beside it, export both, and serve the students with the predictor on at
    NFE 7 and 16. Returns the launches of kernels 1 and 2 over the served
    requests and of kernels 1, 2, 4a, 4b, 4c over the distillation steps."""
    import torch

    from eraxvif5tts_tpu_torch.compression.convert import reference_backbone_state_dict
    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.models.cfm import CFM
    from eraxvif5tts_tpu_torch.models.dit import DiT
    from eraxvif5tts_tpu_torch.models.duration import (
        DurationPredictor,
        predictor_vocab_size,
        save_duration_predictor,
    )
    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.training.distill import DistillConfig, DistillTrainer
    from eraxvif5tts_tpu_torch.training.trainer import batch_seed, make_optimizer

    teacher_cfg = PRESETS["F5TTS_v1_Base"]
    student_arch = dataclasses.replace(train_arch(), depth=COMPRESS_DEPTHS[0])
    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        teacher_ckpt = tmp / "teacher.pt"
        t0 = time.perf_counter()
        save_reference_checkpoint(teacher_ckpt, teacher_cfg, dev)
        log(f"[compress] teacher {teacher_cfg.name}: reference-format checkpoint of N(0, "
            f"{WEIGHT_STD}) weights, seed {SEED + 3}: {teacher_ckpt.stat().st_size / 2**30:.2f} "
            f"GiB written in {time.perf_counter() - t0:.1f} s")
        pruned = prune_with_cli(teacher_ckpt, tmp, teacher_cfg.arch.depth)

        # --- distillation: teacher (bf16, eval) -> 14-block student -------------
        t0 = time.perf_counter()
        teacher = DiT(teacher_cfg.arch, len(VOCAB_CHARS), 100)
        teacher.load_state_dict(reference_backbone_state_dict(str(teacher_ckpt)), strict=True)
        teacher.to(device=dev, dtype=torch.bfloat16)
        student = DiT(student_arch, len(VOCAB_CHARS), 100, compute_dtype=torch.bfloat16)
        student.load_state_dict(reference_backbone_state_dict(
            str(pruned[student_arch.depth])), strict=True)
        student.to(dev)
        torch.manual_seed(SEED + 4)  # the predictor's default initialisation, seeded
        predictor = DurationPredictor(predictor_vocab_size(len(VOCAB_CHARS))).to(dev)
        b, n = TRAIN_BATCH
        frames_per_token = n * 0.75 / (TRAIN_TEXT * 5 / 8)  # the batches' mean lens / text
        with torch.no_grad():  # log-durations near the alignment's, as if trained
            predictor.proj.bias.fill_(math.log(frames_per_token))
        # the distill CLI's recipe: lr 1e-5 with a cosine decay, the predictor at 3e-5;
        # warmup cut to 1 update so that the smoke's updates move the weights
        trainer = DistillTrainer(
            student_cfm=CFM(student), teacher_transformer=teacher,
            optimizer=make_optimizer(learning_rate=1e-5, num_warmup_updates=1,
                                     total_updates=1000, decay_type="cosine"),
            config=DistillConfig(), duration_predictor=predictor, duration_lr=3e-5)
        state = trainer.init_state()
        torch.cuda.synchronize()
        log(f"[compress] distill: teacher depth {teacher_cfg.arch.depth} bf16 eval, "
            f"{sum(p.numel() for p in teacher.parameters()) / 1e6:.1f} M params; student "
            f"depth {student_arch.depth} from {pruned[student_arch.depth].name}, "
            f"{sum(p.numel() for p in student.parameters()) / 1e6:.1f} M fp32 params, bf16 "
            f"compute, dropout {student_arch.dropout}, remat {student_arch.remat_policy}; "
            f"duration predictor {sum(p.numel() for p in predictor.parameters()) / 1e6:.2f} M "
            f"params (vocab {predictor.vocab_size}); built in {time.perf_counter() - t0:.1f} s")
        check_teacher_against_plain(teacher, dev)
        check_distill_against_plain(trainer, state, dev)

        def make_batch(i):
            return train_batch(dev, SEED + 20 + i)

        depth_t, depth_s = teacher_cfg.arch.depth, student_arch.depth
        want = [depth_t, depth_t, 2 * depth_s, depth_s, depth_s]
        reset_serving_counts()
        for fn in (ta.flash_forward, ta.flash_dq, ta.flash_dkv):
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for i in range(4):  # a warm-up step, then three timed; 0 and 1 with an alignment
            batch = make_batch(i)
            if i < 2:
                batch["attn"] = alignment(batch["lens"], batch["text"], n)
            before = distill_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(
                state, batch, torch.Generator(device=dev).manual_seed(batch_seed(SEED, 1, i)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if i:
                walls.append(wall)
            counts = [c - c0 for c, c0 in zip(distill_counts(), before)]
            log(f"[compress] distill step {i} ({'warm-up' if i == 0 else 'timed'}) b={b} n={n}"
                f"{' with attn' if i < 2 else ''}: "
                + ", ".join(f"{k} {v:.5f}" for k, v in metrics.items() if k != "skipped")
                + f", skipped {metrics['skipped']:.0f}; {wall:.3f} s; launches kernel 1 / 2 / "
                f"4a / 4b / 4c {counts}")
            if not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"]:
                raise AssertionError(f"distill step {i}: non-finite loss or skipped")
            if counts != want:
                raise AssertionError(f"distill step {i}: launches {counts}, expected {want} "
                                     f"(teacher {depth_t} x kernels 1 and 2; student forward "
                                     f"twice, checkpointed, and one backward a block)")
        step_s = statistics.median(walls)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"[compress] distill steps 1-3 median {step_s:.3f} s per step ({b} x {n} frames: "
            f"{b * n / step_s:.0f} frames/s), peak memory {peak / 2**30:.2f} GiB")
        launches["distill"] = dict(zip(("serving_attention", "ln_mod_matmul",
                                        "train_attention_fwd", "train_attention_dq",
                                        "train_attention_dkv"), distill_counts()))
        if state.step != 4:
            raise AssertionError(f"{state.step} distill updates applied, expected 4")

        profile_train_step(trainer, state, make_batch(4), dev, step_s, "[compress] distill:")

        # --- export, then serve the students with the predictor --------------------
        student_ckpt, dur_ckpt = tmp / f"student_{depth_s}.pt", tmp / "duration.pt"
        trainer.export_student_torch(state, str(student_ckpt), depth=depth_s)
        # the predictor saw text ids + 1 in training: its phoneme map gives each
        # character (a phoneme of the character fallback) that id
        save_duration_predictor(str(dur_ckpt), state.dur_predictor,
                                {c: i + 1 for c, i in vocab.items() if not c.isspace()},
                                update=state.step)
        del trainer, state, teacher, student, predictor
        torch.cuda.empty_cache()
        log(f"[compress] exported the EMA student ({student_ckpt.stat().st_size / 2**30:.2f} "
            f"GiB) and the duration predictor ({dur_ckpt.stat().st_size / 2**20:.1f} MiB)")

        served = {}
        for depth, nfe in COMPRESS_SERVE:
            if depth not in served:
                ckpt = student_ckpt if depth == depth_s else pruned[depth]
                name = f"F5TTS_v1_Pruned_{depth}"
                wrapper = F5TTSWrapper(name, ckpt_path=str(ckpt), vocab_char_map=vocab,
                                       device=dev, compute_dtype="bfloat16", nfe_step=nfe,
                                       use_duration_predictor=True,
                                       duration_predictor_ckpt=str(dur_ckpt))
                randomize((wrapper.vocoder,), SEED)
                if wrapper.config.arch.depth != depth:
                    raise AssertionError(f"{ckpt.name} served at depth "
                                         f"{wrapper.config.arch.depth}, not {depth}")
                tag = f"[compress] {name} ({'distilled' if depth == depth_s else 'pruned'})"
                check_dit_against_plain(wrapper.transformer, dev, tag)
                ref = load_reference(wrapper)
                warm_smallest(wrapper, ref, nfe_step=2)
                served[depth] = (wrapper, ref, tag)
            wrapper, ref, tag = served[depth]
            predicted = []
            duration_for = wrapper._duration_for

            def logged(ref_, text, speed, fix, duration_for=duration_for, ref=ref,
                       predicted=predicted):
                frames = duration_for(ref_, text, speed, fix)
                predicted.append(frames - ref.n_frames)
                return frames

            wrapper._duration_for = logged
            try:
                counts = generate_counted(wrapper, ref, TEXTS, nfe, f"{tag} NFE {nfe}:",
                                          ("serving_attention", "ln_mod_matmul"))
            finally:
                del wrapper._duration_for
            log(f"{tag} NFE {nfe}: the duration predictor's frames per chunk (after the "
                f"{ref.n_frames}-frame prompt, speed applied): {predicted}")
            launches[f"serve_{depth}_{nfe}"] = {k: counts[k] for k in
                                                ("serving_attention", "ln_mod_matmul")}
        wrapper, ref, tag = served[depth_s]
        phase_server(wrapper, ref, TEXTS[:1], tag, nfe=COMPRESS_SERVE[0][1])
    return launches


TRAIN_CLI_ROWS = 140  # clips of the [train-cli] dataset
TRAIN_CLI_SECONDS = (3.0, 20.0)  # their lengths
TRAIN_CLI_FOCUS = 2  # duration-focus updates before the full ones
TRAIN_CLI_SAVE = 3  # save_per_updates: one model_3 save with its sample
MAS_AGREE = 0.99  # share of tokens whose card durations equal the CPU's


def train_cli_rows(tmp: Path, rows: int = TRAIN_CLI_ROWS) -> list:
    """The [train-cli] dataset: ``rows`` clips of 3-20 s written as 24 kHz wavs
    under ``tmp``, each the bundled clip tiled to its length at a gain of its
    own with a little seeded noise, with a text of about 14 characters a
    second from the smoke's sentences and its characters as space-separated
    phonemes (the phonemizer's character fallback)."""
    import numpy as np

    from eraxvif5tts_tpu_torch.audio.io import read_wav, write_wav
    from eraxvif5tts_tpu_torch.audio.resample import resample

    example = ROOT / "eraxvif5tts_tpu" / "infer" / "examples" / "basic" / "basic_ref_en.wav"
    clip, sr = read_wav(str(example))
    clip = clip.mean(axis=0)
    if sr != 24000:
        clip = resample(clip, sr, 24000)
    rng = np.random.default_rng(SEED + 30)
    words = " ".join(BATCH_TEXTS).split()
    out = []
    for i in range(rows):
        seconds = float(rng.uniform(*TRAIN_CLI_SECONDS))
        n = int(seconds * 24000)
        wav = np.tile(clip, n // len(clip) + 1)[:n] * rng.uniform(0.5, 1.0)
        wav = (wav + 0.003 * rng.standard_normal(n)).astype(np.float32)
        path = tmp / f"clip_{i:03d}.wav"
        write_wav(str(path), wav, 24000)
        text = ""
        while len(text) < 14 * seconds:
            text += words[int(rng.integers(len(words)))] + " "
        text = text.strip()
        out.append({"audio_path": str(path), "text": text, "duration": n / 24000,
                    "phoneme": " ".join(c for c in text if not c.isspace())})
    return out


def check_mas_card_vs_cpu(trainer, state, batch, dev, tag: str, smi: str) -> dict:
    """MAS on one real batch with each algorithm on the card against the CPU:
    the similarity of the align embedding and the fixed mel projection on
    each device, then its durations; every row sums to its mel length, at
    least MAS_AGREE of the tokens agree (an exact tie, such as the boundary
    between two equal neighbouring phonemes, is broken by each device's
    rounding), and the card's time per algorithm. Returns the times (ms)."""
    import torch

    from eraxvif5tts_tpu_torch.models.modules import fp32_convolutions
    from eraxvif5tts_tpu_torch.training import alignment as al

    def similarity(device):
        ph = torch.as_tensor(batch["phoneme"], device=device).long()
        lens = torch.as_tensor(batch["lens"], device=device)
        mel = torch.as_tensor(batch["mel"], device=device)
        align = copy.deepcopy(state.dur_align).to(device)
        plens = (ph > 0).sum(dim=1)
        with torch.no_grad(), fp32_convolutions():
            sim = al.build_similarity(align.embed(ph), mel, trainer._mel_proj.to(device),
                                      plens, lens)
        return sim, plens, lens

    card, cpu = similarity(dev), similarity(torch.device("cpu"))
    b, nt, frames = card[0].shape
    times = {}
    for algorithm in ("window", "progressive", "viterbi"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = al.monotonic_alignment_durations(*card, algorithm)
        torch.cuda.synchronize()
        times[algorithm] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = al.monotonic_alignment_durations(*cpu, algorithm)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        got = got.cpu()
        plens, lens = cpu[1], cpu[2]
        valid = torch.arange(nt)[None, :] < plens[:, None]
        differ = int(((got != want) & valid).sum())
        tokens = int(valid.sum())
        rows = [i for i in range(b) if 0 < plens[i] <= lens[i]]
        sums_ok = all(int(got[i].sum()) == int(lens[i]) for i in rows)
        log(f"{tag} MAS {algorithm} on one real batch [{b}, {nt} phonemes, {frames} frames]: "
            f"card {times[algorithm]:.1f} ms, CPU {cpu_ms:.1f} ms; {differ} of {tokens} "
            f"tokens differ from the CPU's; rows summing to their mel length {sums_ok} "
            f"({len(rows)} rows); {smi}")
        if not sums_ok or differ > (1 - MAS_AGREE) * tokens:
            raise AssertionError(f"{tag} MAS {algorithm}: card against CPU, {differ} of "
                                 f"{tokens} tokens differ, row sums ok {sums_ok}")
    return times


def phase_train_cli(dev, smi: str, cfg=None, rows: int = TRAIN_CLI_ROWS) -> dict:
    """The training CLI's path at full F5TTS_v1_Base width: the YAML config as
    the port loads it, an in-memory CustomDataset of ``rows`` wav files (the
    host mel FFT runs per sample in the worker pool, batches prefetched),
    ``build_sampler`` -> ``build_trainer`` with a duration predictor ->
    ``_run_training`` for one epoch (two focus updates, then full ones, a
    ``model_3`` save with its sample, ``model_last``), then a resume from
    ``model_3`` and MAS on the card against the CPU. ``cfg``: another
    training config, for a rehearsal. Returns the launches by kernel."""
    import numpy as np
    import torch

    from eraxvif5tts_tpu_torch.configs import load_yaml_config
    from eraxvif5tts_tpu_torch.models.duration import (
        DurationPredictor,
        load_duration_predictor,
        predict_duration_frames,
        predictor_vocab_size,
    )
    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.text.phoneme import PhonemeMap
    from eraxvif5tts_tpu_torch.training import alignment, cli
    from eraxvif5tts_tpu_torch.training.dataset import CustomDataset

    tag = "[train-cli]"
    cfg = cfg or load_yaml_config(str(ROOT / "configs" / "F5TTS_v1_Base.yaml"))
    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    kernels = (ta.flash_forward, ta.flash_dq, ta.flash_dkv)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "wavs").mkdir()
        # one epoch; the warmup cut from 20,000 updates to 1 so that its updates
        # move the weights; one save at update 3 (its sample runs there)
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, tokenizer="custom"),
            optim=dataclasses.replace(cfg.optim, epochs=1, num_warmup_updates=1),
            ckpts=dataclasses.replace(cfg.ckpts, save_per_updates=TRAIN_CLI_SAVE,
                                      save_dir=str(tmp / "ckpts")))
        t0 = time.perf_counter()
        dataset = CustomDataset(train_cli_rows(tmp / "wavs", rows),
                                hop_length=cfg.model.mel_spec.hop_length,
                                target_sample_rate=cfg.model.mel_spec.target_sample_rate,
                                mel_spec_kwargs=dataclasses.asdict(cfg.model.mel_spec))
        sampler = cli.build_sampler(dataset, cfg, SEED)
        seconds = sum(dataset.durations)
        log(f"{tag} dataset: {len(dataset)} wav files of {TRAIN_CLI_SECONDS[0]:.0f}-"
            f"{TRAIN_CLI_SECONDS[1]:.0f} s ({seconds / 60:.1f} min) written in "
            f"{time.perf_counter() - t0:.1f} s; {len(sampler)} batches of <= "
            f"{cfg.datasets.batch_size_per_gpu} frames and {cfg.datasets.max_samples} "
            f"samples ({[len(b) for b in sampler.batches]} rows); {cfg.datasets.num_workers} "
            "mel workers, prefetch 2")
        if len(sampler) < TRAIN_CLI_SAVE + 1:
            raise AssertionError(f"{tag} {len(sampler)} batches: the phase needs "
                                 f"{TRAIN_CLI_SAVE + 1}")

        t0 = time.perf_counter()
        pred_vocab = predictor_vocab_size(len(vocab))
        torch.manual_seed(SEED + 31)  # the predictor's default initialisation, seeded
        predictor = DurationPredictor(vocab_size=pred_vocab, d_model=512, d_filter=32,
                                      kernel_size=3, dropout=0.5)
        phoneme_map = PhonemeMap(max_index=pred_vocab - 1)
        trainer = cli.build_trainer(cfg, len(vocab), cli._total_updates(sampler, cfg),
                                    duration_predictor=predictor,
                                    duration_focus_updates=TRAIN_CLI_FOCUS,
                                    phoneme_map=phoneme_map, device=dev)
        dit = trainer.cfm.transformer
        randomize((dit,), SEED)
        state = trainer.init_state()
        arch = dit.arch
        depth = arch.depth
        torch.cuda.synchronize()
        log(f"{tag} {cfg.model.name} from configs/F5TTS_v1_Base.yaml: dim {arch.dim} depth "
            f"{depth} heads {arch.heads}x{arch.dim_head}, {cfg.model.compute_dtype} compute, "
            f"checkpoint_activations {arch.checkpoint_activations}, dropout {arch.dropout}, "
            f"N(0, {WEIGHT_STD}) seed {SEED}; duration predictor (vocab {pred_vocab}, 512, "
            f"32, 3, 0.5) seed {SEED + 31}; lr {cfg.optim.learning_rate}, warmup cut to 1; "
            f"built in {time.perf_counter() - t0:.1f} s")

        # --- instruments: per update wall / data wait / MAS, kernels, saves ----
        steps, saves, waits, mas_s = [], [], [], []
        plain_step = trainer.train_step
        plain_prefetch = cli.prefetch_batches
        plain_mas = alignment.monotonic_alignment_durations
        plain_save = trainer.save_checkpoint

        def timed_prefetch(gen, depth=2):
            it = plain_prefetch(gen, depth)
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t)
                yield batch

        def timed_mas(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = plain_mas(*args, **kwargs)
            torch.cuda.synchronize()
            mas_s.append(time.perf_counter() - t)
            return out

        def timed_save(state, *args, **kwargs):
            t = time.perf_counter()
            path = plain_save(state, *args, **kwargs)
            size = sum(f.stat().st_size for f in Path(path).iterdir())
            saves.append((Path(path).name, size, time.perf_counter() - t))
            return path

        def watched_step(state, batch, draws):
            # the snapshots on the host: the peak below is the CLI's own
            def host(tensors):
                return [t.detach().to("cpu", copy=True) for t in tensors]

            params = host(state.model.parameters())
            ema = host(state.ema_params.values())
            dur = host(state.dur_predictor.parameters())
            before = [fn.launches for fn in kernels]
            focus = state.step < TRAIN_CLI_FOCUS  # the updates before it count
            n_mas = len(mas_s)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = plain_step(state, batch, draws)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = [fn.launches - c for fn, c in zip(kernels, before)]
            moved, ema_moved, dur_moved = (
                sum(not torch.equal(x.detach().cpu(), x0) for x, x0 in zip(now, then))
                for now, then in ((state.model.parameters(), params),
                                  (state.ema_params.values(), ema),
                                  (state.dur_predictor.parameters(), dur)))
            steps.append(dict(step=state.step, focus=focus, wall=wall, counts=counts,
                              wait=waits[-1] if waits else float("nan"),
                              method=trainer.alignment_manager.current_method,
                              loss=metrics["loss"], metrics=metrics, moved=moved,
                              ema_moved=ema_moved, dur_moved=dur_moved,
                              mas=sum(mas_s[n_mas:]), real=int(np.sum(batch["lens"])),
                              shape=tuple(batch["mel"].shape)))
            return state, metrics

        def run(state, resume=None):
            return cli._run_training(trainer, cfg, dataset, sampler, vocab, state, SEED,
                                     tokenize=cli._make_tokenize("custom"),
                                     phoneme_map=phoneme_map, resume=resume, log_every=1)

        trainer.train_step = watched_step
        trainer.save_checkpoint = timed_save
        cli.prefetch_batches = timed_prefetch
        alignment.monotonic_alignment_durations = timed_mas
        before_serving = serving_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            t0 = time.perf_counter()
            state = run(state)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            first = list(steps)
            serving = {k: v - before_serving[k] for k, v in serving_counts().items()}
            peak = torch.cuda.max_memory_allocated(dev)
            steps.clear()
            t0 = time.perf_counter()
            run(state, resume=str(tmp / "ckpts" / f"model_{TRAIN_CLI_SAVE}"))
            resume_s = time.perf_counter() - t0
        finally:
            del trainer.train_step, trainer.save_checkpoint
            cli.prefetch_batches = plain_prefetch
            alignment.monotonic_alignment_durations = plain_mas

        # --- the run's readings ------------------------------------------------
        for s in first:
            b, n, wait = *s["shape"][:2], s["wait"]
            m = s["metrics"]
            log(f"{tag} update {s['step']} ({'focus' if s['focus'] else 'full'}, MAS "
                f"{s['method']}) [{b}, {n}] {s['real']} real frames: wall {s['wall']:.3f} s, "
                f"{s['real'] / s['wall']:.0f} real / {b * n / s['wall']:.0f} padded frames/s, "
                f"host wait for the batch {wait * 1e3:.1f} ms, MAS {s['mas'] * 1e3:.1f} ms "
                f"({100 * s['mas'] / s['wall']:.1f} % of the wall); loss {m['loss']:.5f} "
                f"cfm {m['cfm_loss']:.5f} duration {m['duration_loss']:.5f} mae "
                f"{m['duration_mae']:.3f} coverage {m['align_coverage']:.3f} diagonal "
                f"{m['align_diagonal']:.3f} weight {m['duration_weight']:.2f} grad_norm "
                f"{m['grad_norm']:.4f}; launches fwd/dq/dkv {s['counts']}; tensors moved: "
                f"backbone {s['moved']}, EMA {s['ema_moved']}, predictor {s['dur_moved']}; "
                f"{smi}")
        n_params = sum(1 for _ in dit.parameters())
        n_dur = sum(1 for _ in state.dur_predictor.parameters())
        for s in first:
            want = [depth, 0, 0] if s["focus"] else (
                [2 * depth if arch.checkpoint_activations else depth, depth, depth])
            if s["counts"] != want:
                raise AssertionError(f"{tag} update {s['step']}: launches {s['counts']}, "
                                     f"expected {want}")
            if s["focus"] and (s["moved"] or s["ema_moved"] or s["dur_moved"] != n_dur):
                raise AssertionError(f"{tag} focus update {s['step']}: backbone tensors moved "
                                     f"{s['moved']}, EMA {s['ema_moved']}, predictor "
                                     f"{s['dur_moved']} of {n_dur}")
            if not s["focus"] and (s["moved"] != n_params or s["ema_moved"] != n_params):
                raise AssertionError(f"{tag} full update {s['step']}: backbone tensors moved "
                                     f"{s['moved']}, EMA {s['ema_moved']} of {n_params}")
            if not all(math.isfinite(s["metrics"][k]) for k in ("loss", "grad_norm")):
                raise AssertionError(f"{tag} update {s['step']}: non-finite loss or norm")
        if [s["focus"] for s in first[:TRAIN_CLI_FOCUS + 1]] != [True] * TRAIN_CLI_FOCUS + [False]:
            raise AssertionError(f"{tag} phases {[s['focus'] for s in first]}: expected "
                                 f"{TRAIN_CLI_FOCUS} focus updates, then full ones")
        walls = [s["wall"] for s in first]
        full = [s for s in first if not s["focus"]]
        mas_share = sum(s["mas"] for s in first) / sum(walls)
        log(f"{tag} one epoch of {len(first)} updates in {run_s:.1f} s of wall ({sum(walls):.1f} "
            f"s in train_step); the full updates' median "
            f"{statistics.median(s['wall'] for s in full):.3f} s; MAS {100 * mas_share:.1f} % of "
            f"the updates' wall; the host's wait for a batch: first {first[0]['wait'] * 1e3:.0f} "
            f"ms (the mel FFT of a whole batch), then median "
            f"{statistics.median(s['wait'] for s in first[1:]) * 1e3:.1f} ms; peak memory "
            f"{peak / 2**30:.2f} GiB; {smi}")
        for name, size, secs in saves:
            log(f"{tag} checkpoint {name}: {size / 2**30:.2f} GiB saved in {secs:.2f} s")

        # the samples of the model_{3k} saves: kernels 1 and 2, their files
        nfe = 16  # make_sample_fn's default
        sampled = [s["step"] for s in first if s["step"] % TRAIN_CLI_SAVE == 0]
        want = depth * nfe * len(sampled)
        if serving["serving_attention"] != want or serving["ln_mod_matmul"] != want:
            raise AssertionError(f"{tag} the samples launched kernel 1 "
                                 f"{serving['serving_attention']} and kernel 2 "
                                 f"{serving['ln_mod_matmul']} times, expected {want} each")
        from eraxvif5tts_tpu_torch.audio.io import read_wav

        for step in sampled:
            base = tmp / "ckpts" / "samples" / f"update_{step}_0"
            mel = np.load(f"{base}.npy")
            wav, _ = read_wav(f"{base}.gl.wav")
            if not (np.isfinite(mel).all() and np.isfinite(wav).all() and mel.size and wav.size):
                raise AssertionError(f"{tag} the sample's mel or wave is empty or not finite")
            log(f"{tag} sample at update {step}: mel {mel.shape}, Griffin-Lim wave "
                f"{wav.shape[-1] / 24000:.2f} s")
        log(f"{tag} kernel 1 and kernel 2 launched {want} times each in the samples "
            f"({depth} blocks x NFE {nfe} x {len(sampled)})")

        # the predictor's file, loaded on the card
        path = tmp / "ckpts" / "duration_predictor_last.pt"
        model, loaded = load_duration_predictor(str(path), dev)
        frames = predict_duration_frames(model, loaded, TEXTS[0])
        if loaded != dict(phoneme_map) or frames <= 0:
            raise AssertionError(f"{tag} {path.name}: map equal {loaded == dict(phoneme_map)}, "
                                 f"{frames} predicted frames")
        log(f"{tag} {path.name}: {len(loaded)} phonemes, {frames} frames predicted for "
            f"{TEXTS[0]!r} on the card")

        # the resume from model_3: the next update's loss equals the first run's
        redo = steps[0]
        ref = next(s for s in first if s["step"] == redo["step"])
        rel = abs(redo["loss"] - ref["loss"]) / abs(ref["loss"])
        log(f"{tag} resumed from model_{TRAIN_CLI_SAVE} in {resume_s:.1f} s ({len(steps)} "
            f"updates run, the skip of {TRAIN_CLI_SAVE} batches inside epoch 0): update "
            f"{redo['step']} loss {redo['loss']:.8f} against {ref['loss']:.8f}, relative "
            f"{rel:.3g} (limit 1e-6)")
        if rel > 1e-6:
            raise AssertionError(f"{tag} the resumed update's loss differs by {rel:.3g}")

        batch = next(iter(cli.epoch_batches(dataset, sampler, vocab, 0,
                                            tokenize=cli._make_tokenize("custom"),
                                            phoneme_map=phoneme_map)))
        check_mas_card_vs_cpu(trainer, state, batch, dev, tag, smi)
        for fn, name in zip(kernels, ("fwd", "dq", "dkv")):
            launches[f"train_attention_{name}"] = sum(
                s["counts"][("fwd", "dq", "dkv").index(name)] for s in first)
        launches.update({k: serving[k] for k in ("serving_attention", "ln_mod_matmul")})
    log(f"{tag} launches on the CLI path: {launches}")
    return launches


BENCH_ITERS = 3  # timed calls of tools/bench.py a dtype, after its warm-up


def phase_bench(tag: str = "[bench]") -> dict:
    """`tools/bench.py`'s workload (a random F5TTS_v1_Base with Vocos, a
    1024-frame bucket with a 256-frame prompt, NFE 32: one graph replay and
    the PCM's fetch a call) in fp32 and in bf16. Its lines are logged under
    ``tag``, its JSON line too, so that the smoke's last two lines stay its
    only bare JSON. Returns the JSON lines by dtype."""
    import io

    from eraxvif5tts_tpu_torch.tools import bench

    results = {}
    for dtype in ("float32", "bfloat16"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--dtype", dtype, "--iters", str(BENCH_ITERS)])
        lines = out.getvalue().strip().splitlines()
        line = json.loads(lines[-1])
        if rc != 0 or list(line) != ["metric", "value", "unit", "vs_baseline"] or not (
                line["value"] > 0 and line["metric"] == "rtf_nfe32"):
            raise AssertionError(f"{tag} tools/bench.py --dtype {dtype}: {lines}")
        for text in lines:
            log(f"{tag} {dtype}: {text}")
        results[dtype] = line
    return results


# the mesh phase: two ranks on the one card over gloo (NCCL refuses two ranks
# on one device), a world of one over NCCL
MESH_ROWS = 2  # rows per data rank at DP 2: a global batch of 4 x 2048 frames
MESH_FRAMES = 2048
MESH_NFE = 8
MESH_TEXTS = TEXTS[:2] + BATCH_TEXTS[3:5]
# Limits against one rank on the same global batch: bf16 GEMMs on another
# row count round differently, and the sums over the ranks reassociate. On
# an H100 the sound steps read at most 6.03e-6 on the loss (DP step 2) and
# 1.28e-5 on the norm; the planted faults (`mesh_control_steps`) at least
# 1.56e-5 on the loss (TP, kernel 4's heads hashed from 0; the other faults
# 1.55e-4 and more). The PCM reads 0.0106-0.0109 after 8 bf16 Euler steps,
# the planted fault (row projections not summed over the model axis)
# 0.0327-0.0389: random weights leave the blocks a small share of the
# output. A doubled bias read 0.0137, inside this limit; the CPU test holds
# the model mesh's fp32 PCM to the one-device's within 3e-4, where it fails.
MESH_LOSS_TOL = 1e-5  # relative, the loss of each step
MESH_NORM_TOL = 1e-4  # relative, the gradient norm of each step
MESH_PCM_TOL = 0.02  # relative L2 of generate_batch's PCM, 8 bf16 Euler steps apart
# Two runs of one update on the card, relative (gradient norms and the
# parameters' sum; the losses must be equal): the backward is not bitwise
# deterministic there (atomic scatter-adds, e.g. the text embedding's
# gradient), and two runs of the same step left the sums 2.5e-14 apart. It
# holds ZeRO-1 against the replicated run and a resume against the run.
MESH_RERUN_TOL = 1e-9
MESH_TIMEOUT = 600
# The other backbones' phases run at full width and cut depth (the MMDiT's 22
# blocks to 7, the UNetT's 24 layers to 8), which pays for the mesh phase.
# MMDiT training keeps 11 blocks: at 7 its masked-tile control moves the
# whole gradient by 0.0065, inside MMDIT_TOLS' 0.007
MMDIT_DEPTH = 7
MMDIT_TRAIN_DEPTH = 11
E2TTS_DEPTH = 8


def cut_depth(cfg, depth: int):
    """``cfg`` with ``depth`` blocks (layers), every width kept."""
    return dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, depth=depth))


def mesh_counters():
    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    return {"serving_attention": sa.serving_attention, "ln_mod_matmul": fm.ln_mod_matmul,
            "train_attention_fwd": ta.flash_forward, "train_attention_dq": ta.flash_dq,
            "train_attention_dkv": ta.flash_dkv}


def mesh_trainer(dev, mesh, zero1: bool = False, checkpoint_dir=None):
    """A fresh full-width F5TTS_v1_Base trainer (train_arch: bf16 compute,
    dropout 0.1, blocks checkpointed) on ``mesh`` (None: one rank), the same
    seeded weights on every rank; lr 1e-4 from the first update."""
    import torch

    from eraxvif5tts_tpu_torch.models.cfm import CFM
    from eraxvif5tts_tpu_torch.models.dit import DiT
    from eraxvif5tts_tpu_torch.training.trainer import Trainer, make_optimizer

    dit = DiT(train_arch(), text_num_embeds=len(VOCAB_CHARS), mel_dim=100,
              compute_dtype=torch.bfloat16).to(dev)
    randomize((dit,), SEED)
    return Trainer(cfm=CFM(dit.train()), optimizer=make_optimizer(
        learning_rate=1e-4, num_warmup_updates=0, total_updates=1000), mesh=mesh, zero1=zero1,
        checkpoint_dir=checkpoint_dir)


def mesh_steps(trainer, state, dev, steps, rows: int = 2 * MESH_ROWS) -> list:
    """``trainer.train_step`` on the global batches ``steps`` (indices) of
    ``rows`` x MESH_FRAMES: the same batch and draws on every rank. Returns
    (loss, grad norm, wall s) a step."""
    import torch

    from eraxvif5tts_tpu_torch.training.trainer import batch_seed

    out = []
    for i in steps:
        batch = train_batch(dev, SEED + 40 + i, (rows, MESH_FRAMES))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(
            state, batch, torch.Generator(device=dev).manual_seed(batch_seed(SEED, 0, i)))
        torch.cuda.synchronize()
        if not (math.isfinite(m["loss"]) and m["applied"] == 1.0):
            raise AssertionError(f"[mesh] step {i}: {m}")
        out.append((m["loss"], m["grad_norm"], time.perf_counter() - t0))
    return out


def mesh_control_steps(trainer, dev, faults: dict, rows: int) -> dict:
    """Each fault of ``faults`` (name -> a function that puts it into
    ``trainer`` and returns its undo) in turn: the first step's (loss, grad
    norm, wall s) on global batch 0 from a fresh state on the trainer's
    starting weights, which are restored after each."""
    import torch

    first, out = None, {}
    for name, fault in faults.items():
        state = trainer.init_state()
        if first is None:
            first = [p.detach().clone() for p in state.model.parameters()]
        undo = fault(trainer)
        try:
            out[name] = mesh_steps(trainer, state, dev, (0,), rows=rows)[0]
        finally:
            undo()
        with torch.no_grad():
            for p, p0 in zip(state.model.parameters(), first):
                p.copy_(p0)
    return out


def per_rank_mean(trainer):
    """The fault: each data rank divides by its own span count, so the
    ranks' sum is the average of per-rank means, not the global mean."""
    inputs = trainer._inputs

    def faulty(state, batch, draws):
        *head, _ = inputs(state, batch, draws)
        n_data = trainer._n_data
        return (*head, lambda t: t * n_data)

    trainer._inputs = faulty
    return lambda: vars(trainer).pop("_inputs")


def rows_from_zero(trainer):
    """The fault: every data rank hashes its dropout from row 0 (the batch
    offset lost), so the kept bits are not the global batch's."""
    inputs = trainer._inputs

    def faulty(state, batch, draws):
        out = inputs(state, batch, draws)
        trainer._shard.batch_offset = 0
        return out

    trainer._inputs = faulty
    return lambda: vars(trainer).pop("_inputs")


def heads_from_zero(trainer):
    """The fault: every model rank hashes kernel 4's dropout from head 0
    (the head offset lost)."""
    from eraxvif5tts_tpu_torch.models.modules import Attention

    mods = [m for m in trainer.cfm.transformer.modules() if isinstance(m, Attention)]
    kept = [m.head0 for m in mods]
    for m in mods:
        m.head0 = 0

    def undo():
        for m, h in zip(mods, kept):
            m.head0 = h

    return undo


def columns_from_zero(trainer):
    """The fault: every model rank hashes the feed-forward dropout from
    column 0 (the column offset lost)."""
    from eraxvif5tts_tpu_torch.models import modules

    drop = modules.hash_dropout

    def faulty(x, rate, key, batch_offset=0, col_offset=0, cols=None):
        return drop(x, rate, key, batch_offset, 0, cols)

    modules.hash_dropout = faulty
    return lambda: setattr(modules, "hash_dropout", drop)


def unsummed_rows():
    """The fault in serving: a row projection's partial product is not
    summed over the model axis (each rank keeps its own, plus the bias).
    Returns its undo."""
    from eraxvif5tts_tpu_torch.models import modules

    leave = modules.leave

    def faulty(partial, bias, shard):
        return (partial.float() + (0.0 if bias is None else bias.float())).to(partial.dtype)

    modules.leave = faulty
    return lambda: setattr(modules, "leave", leave)


def mesh_shapes():
    """Wrap the model's kernel calls to record the shapes the ranks give
    them (q of kernels 1 and 4 with the offsets, kernel 2's weight)."""
    from eraxvif5tts_tpu_torch.models import modules

    seen = {"kernel 1 q": set(), "kernel 2 weight": set(), "kernel 4 q, offsets": set()}
    attn, ln, train = modules.dot_product_attention, modules.ln_mod_matmul, \
        modules.train_attention

    def attn_(q, *a, **k):
        seen["kernel 1 q"].add(tuple(q.shape))
        return attn(q, *a, **k)

    def ln_(x, scale, shift, w, *a, **k):
        seen["kernel 2 weight"].add(tuple(w.shape))
        return ln(x, scale, shift, w, *a, **k)

    def train_(q, *a, **k):
        seen["kernel 4 q, offsets"].add((tuple(q.shape), k.get("batch_offset", 0),
                                         k.get("head_offset", 0)))
        return train(q, *a, **k)

    modules.dot_product_attention, modules.ln_mod_matmul = attn_, ln_
    modules.train_attention = train_
    return seen


def mesh_rank(rank: int, world: int, tmp: str, device: str = "cuda") -> None:
    """One of the two ranks of the mesh phase (a process of its own on
    cuda:0, gloo): DP 2, TP 2, ZeRO-1 with a resume in a fresh group.
    Writes its readings to ``mesh_{rank}.json`` under ``tmp``."""
    import traceback

    try:
        _mesh_rank(rank, world, Path(tmp), device)
    except BaseException:
        (Path(tmp) / f"mesh_error_{rank}.txt").write_text(traceback.format_exc())
        raise


def _mesh_rank(rank: int, world: int, tmp: Path, device: str) -> None:
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.parallel import mesh as pm

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if device == "cuda":
        torch.cuda.set_device(0)

    def make_mesh(n_model):
        return pm.make_mesh(n_model=n_model, device_type=device)

    dist.init_process_group("gloo", init_method=f"file://{tmp}/group_a", rank=rank,
                            world_size=world)
    counters = mesh_counters()
    shapes = mesh_shapes()
    out: dict = {"rank": rank}

    def segment(name, fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = dict(result, wall_s=time.perf_counter() - t0,
                         peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                         launches={k: c.launches for k, c in counters.items()})
        gc.collect()

    def digest(state) -> float:
        return float(sum(p.detach().double().sum() for p in state.model.parameters()))

    def uncounted():
        # the controls' launches are not the sound run's
        for c in counters.values():
            c.launches = 0

    def dp():
        trainer = mesh_trainer(dev, make_mesh(1))
        controls = mesh_control_steps(trainer, dev, {"per-rank mean": per_rank_mean,
                                                     "rows from 0": rows_from_zero},
                                      2 * MESH_ROWS)
        uncounted()
        state = trainer.init_state()
        return {"steps": mesh_steps(trainer, state, dev, (0, 1)), "digest": digest(state),
                "controls": controls}

    def tp():
        # the same global batch of MESH_ROWS rows on both ranks, each with 8 heads
        trainer = mesh_trainer(dev, make_mesh(2))
        controls = mesh_control_steps(trainer, dev, {"heads from 0": heads_from_zero,
                                                     "columns from 0": columns_from_zero},
                                      MESH_ROWS)
        uncounted()
        state = trainer.init_state()
        return {"steps": mesh_steps(trainer, state, dev, (0,), rows=MESH_ROWS),
                "controls": controls}

    def reference():
        # one rank computes the same global batches from the same weights
        if rank != 0:
            return {}
        trainer = mesh_trainer(dev, None)
        first = [p.detach().clone() for p in trainer.cfm.transformer.parameters()]
        tp_steps = mesh_steps(trainer, trainer.init_state(), dev, (0,), rows=MESH_ROWS)
        with torch.no_grad():
            for p, p0 in zip(trainer.cfm.transformer.parameters(), first):
                p.copy_(p0)
        del first
        return {"steps": mesh_steps(trainer, trainer.init_state(), dev, (0, 1)),
                "tp steps": tp_steps}

    segment("dp", dp)
    segment("tp", tp)
    segment("one rank", reference)
    dist.barrier()

    # TP 2 serving: the same weights through reference-format files
    ck, vk = tmp / "mesh_dit.pt", tmp / "mesh_vocos.pt"
    vocab = {c: i for i, c in enumerate(VOCAB_CHARS)}
    common = dict(model_name="F5TTS_v1_Base", vocab_char_map=vocab, device=dev,
                  compute_dtype="bfloat16", nfe_step=MESH_NFE)

    def serve_one():
        if rank != 0:
            return {}
        w = F5TTSWrapper(**common)
        randomize((w.transformer, w.vocoder), SEED)
        save_reference_checkpoint_of(ck, w.transformer)
        save_reference_vocoder(vk, w.vocoder)
        ref = load_reference(w)
        waves = w.generate_batch(list(MESH_TEXTS), ref=ref, seed=SEED)
        np_save(tmp / "mesh_one.npz", waves)
        return {}

    tp_wrapper = {}

    def serve_tp():
        w = tp_wrapper["w"] = F5TTSWrapper(ckpt_path=str(ck), vocoder_ckpt_path=str(vk),
                                           mesh=make_mesh(2), **common)
        ref = load_reference(w)
        t0 = time.perf_counter()
        waves = w.generate_batch(list(MESH_TEXTS), ref=ref, seed=SEED)
        return {"generate_batch_s": time.perf_counter() - t0,
                "audio_s": sum(len(x) for x in waves) / w.target_sample_rate,
                "pcm": [x.tolist() for x in waves]}

    def serve_control():
        # the same wrapper (its step is eager over gloo: the fault takes effect)
        w = tp_wrapper.pop("w")
        undo = unsummed_rows()
        try:
            waves = w.generate_batch(list(MESH_TEXTS), ref=load_reference(w), seed=SEED)
        finally:
            undo()
        return {"pcm": [x.tolist() for x in waves]}

    segment("serve one rank", serve_one)
    dist.barrier()
    segment("serve tp", serve_tp)
    pcm = out["serve tp"].pop("pcm")
    np_save(tmp / f"mesh_tp_{rank}.npz", [np.asarray(x) for x in pcm])
    segment("serve tp control", serve_control)
    pcm = out["serve tp control"].pop("pcm")
    np_save(tmp / f"mesh_tp_control_{rank}.npz", [np.asarray(x) for x in pcm])

    # ZeRO-1 at DP 2: a step, a save, the next step; then a fresh group resumes
    ckpt_dir = tmp / "mesh_zero1"

    def zero1_run():
        trainer = mesh_trainer(dev, make_mesh(1), zero1=True,
                               checkpoint_dir=str(ckpt_dir))
        state = trainer.init_state()
        first = mesh_steps(trainer, state, dev, (0,))
        held = sum(t.numel() for s_ in state.optimizer.state.values() for k, t in s_.items()
                   if k != "step") + sum(t.numel() for t in state.ema_params.values())
        t0 = time.perf_counter()
        path = trainer.save_checkpoint(state)
        save_s = time.perf_counter() - t0
        return {"steps": first + mesh_steps(trainer, state, dev, (1,)), "save_s": save_s,
                "path": path, "state_numel": held, "digest": digest(state),
                "n_params": sum(p.numel() for p in state.model.parameters())}

    segment("zero1", zero1_run)
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/group_b", rank=rank,
                            world_size=world)

    def zero1_resume():
        trainer = mesh_trainer(dev, make_mesh(1), zero1=True)
        state = trainer.load_checkpoint(out["zero1"]["path"], trainer.init_state())
        steps = mesh_steps(trainer, state, dev, (1,))
        return {"steps": steps, "step": state.step, "digest": digest(state)}

    segment("zero1 resume", zero1_resume)
    out["shapes"] = {k: sorted(map(str, v)) for k, v in shapes.items()}
    (tmp / f"mesh_{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def np_save(path: Path, waves) -> None:
    import numpy as np

    np.savez(path, *[np.asarray(w) for w in waves])


def np_load(path: Path) -> list:
    import numpy as np

    with np.load(path) as f:
        return [f[f"arr_{i}"] for i in range(len(f.files))]


def mesh_nccl(dev, tmp: Path) -> dict:
    """A world of one over NCCL in this process: a DP step on the mesh, then
    an all-reduce and a barrier through the NCCL group."""
    import torch
    import torch.distributed as dist

    from eraxvif5tts_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", rank=0, world_size=1)
    try:
        counters = mesh_counters()
        for c in counters.values():
            c.launches = 0
        trainer = mesh_trainer(dev, make_mesh(n_model=1, device_type="cuda"))
        steps = mesh_steps(trainer, trainer.init_state(), dev, (0,))
        t = torch.tensor([steps[0][0]], device=dev)
        dist.all_reduce(t)
        dist.barrier()
        if float(t) != steps[0][0]:
            raise AssertionError(f"[mesh] NCCL all-reduce over a world of one: {float(t)}")
        return {"backend": dist.get_backend(), "steps": steps,
                "launches": {k: c.launches for k, c in counters.items()},
                "captured": nccl_captured_leave(dev)}
    finally:
        dist.destroy_process_group()


def nccl_captured_leave(dev) -> str:
    """What a TP chunk step over NCCL captures in its CUDA graph: a row
    projection's sum over the model axis (`parallel.shard.leave`, here over
    the world of one), captured, then replayed on new inputs, bit for bit
    its eager run on them."""
    import torch
    import torch.distributed as dist

    from eraxvif5tts_tpu_torch.parallel.shard import ShardContext, leave

    ctx = ShardContext(group=dist.group.WORLD, rank=0, size=1)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((4, 768, 1024), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((1024,), generator=g, device=dev)
    with torch.no_grad():
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = leave(x, bias, ctx)
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
        graph.replay()
        eager = leave(x, bias, ctx)
    torch.cuda.synchronize()
    if not torch.equal(captured, eager):
        raise AssertionError("[mesh] the captured NCCL all-reduce's replay is not its eager run: "
                             f"max |difference| {float((captured - eager).abs().max())}")
    return f"{tuple(x.shape)} bf16, replay = eager bit for bit"


def phase_mesh(dev) -> dict:
    """Multi-device training and serving on the one card: a world of one
    over NCCL here (a DP step, and an all-reduce captured in a CUDA graph),
    then two ranks over gloo in processes of their own (spawned: this
    process holds a CUDA context), each on cuda:0 at full F5TTS_v1_Base
    width (bf16 compute, dropout 0.1): DP 2 (two steps at 2 x 2048 frames a
    rank) and TP 2 (one step, and `generate_batch` of four texts at NFE 8)
    held against one rank on the same global batch, each check beside
    planted faults that its limits must refuse, ZeRO-1 at DP 2 (a step, a
    save, a resume in a fresh group that gives the same next step), each
    rank's peak memory and kernel launches. Returns rank 0's launches of
    the training kernels in the DP steps."""
    import gc

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        nccl = mesh_nccl(dev, tmp)
        log(f"[mesh] world of one over {nccl['backend']}: DP step loss "
            f"{nccl['steps'][0][0]:.5f}, grad_norm {nccl['steps'][0][1]:.5f}, "
            f"{nccl['steps'][0][2]:.3f} s; all-reduce and barrier through it; launches "
            f"{nccl['launches']}; a row projection's all-reduce captured in a CUDA graph: "
            f"{nccl['captured']}")
        gc.collect()
        torch.cuda.empty_cache()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank, args=(r, 2, tmp_s, dev.type)) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + MESH_TIMEOUT
        for p in procs:
            p.join(max(deadline - time.perf_counter(), 1.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for r in range(2):
            err = tmp / f"mesh_error_{r}.txt"
            if err.is_file():
                raise AssertionError(f"[mesh] rank {r} failed:\n{err.read_text()}")
        if [p.exitcode for p in procs] != [0, 0]:
            raise AssertionError(f"[mesh] ranks exited with {[p.exitcode for p in procs]}")
        ranks = [json.loads((tmp / f"mesh_{r}.json").read_text()) for r in range(2)]
        one = np_load(tmp / "mesh_one.npz")
        tp_waves = [np_load(tmp / f"mesh_tp_{r}.npz") for r in range(2)]
        control_waves = [np_load(tmp / f"mesh_tp_control_{r}.npz") for r in range(2)]

    def pcm_rel(waves) -> list[float]:
        return [float(np.linalg.norm(g.astype(np.float64) - w) / np.linalg.norm(w))
                for g, w in zip(waves, one)]

    ref = ranks[0]["one rank"]
    failed = []  # every reading is logged before the phase fails
    # the faults each check must see: every control beyond a limit
    for r, out in enumerate(ranks):
        for seg, want in (("dp", ref["steps"][0]), ("tp", ref["tp steps"][0])):
            for name, (loss, norm, _) in out[seg]["controls"].items():
                e_loss, e_norm = abs(loss - want[0]) / abs(want[0]), \
                    abs(norm - want[1]) / abs(want[1])
                log(f"[mesh] rank {r} {seg} control ({name}) step 1: loss relative {e_loss:.3g} "
                    f"(tol {MESH_LOSS_TOL}), grad_norm relative {e_norm:.3g} "
                    f"(tol {MESH_NORM_TOL})")
                if e_loss <= MESH_LOSS_TOL and e_norm <= MESH_NORM_TOL:
                    failed.append(f"the {seg} control ({name}) on rank {r} passes the limits")
        rel = pcm_rel(control_waves[r])
        log(f"[mesh] rank {r} TP generate_batch control (row projections not summed over "
            "the model axis): PCM "
            "relative L2 vs one rank " + ", ".join(f"{x:.3g}" for x in rel)
            + f" (tol {MESH_PCM_TOL})")
        if min(rel) <= MESH_PCM_TOL:
            failed.append(f"the TP generate_batch control on rank {r} passes the PCM limit")
    for r, out in enumerate(ranks):
        for seg in ("dp", "tp", "serve tp", "serve tp control", "zero1", "zero1 resume"):
            o = out[seg]
            log(f"[mesh] rank {r} {seg}: {o['wall_s']:.1f} s, peak {o['peak_gib']:.2f} GiB, "
                f"launches {o['launches']}")
        for seg, steps, want in (("dp", out["dp"]["steps"], ref["steps"]),
                                 ("tp", out["tp"]["steps"], ref["tp steps"])):
            for i, ((loss, norm, wall), (rl, rn, _)) in enumerate(zip(steps, want)):
                e_loss, e_norm = abs(loss - rl) / abs(rl), abs(norm - rn) / abs(rn)
                log(f"[mesh] rank {r} {seg} step {i + 1}: loss {loss:.6f} (one rank {rl:.6f}, "
                    f"relative {e_loss:.3g}, tol {MESH_LOSS_TOL}), grad_norm {norm:.5f} (one rank "
                    f"{rn:.5f}, relative {e_norm:.3g}, tol {MESH_NORM_TOL}), {wall:.3f} s")
                if e_loss > MESH_LOSS_TOL or e_norm > MESH_NORM_TOL:
                    failed.append(f"{seg} step {i + 1} on rank {r} is not the one rank's step")
        depth = train_arch().depth
        for seg, n_steps in (("dp", 2), ("tp", 1), ("zero1", 2), ("zero1 resume", 1)):
            got = [out[seg]["launches"][f"train_attention_{k}"] for k in ("fwd", "dq", "dkv")]
            if got != [2 * depth * n_steps, depth * n_steps, depth * n_steps]:
                failed.append(f"rank {r} {seg}: kernel 4 launches {got}")
        serve = out["serve tp"]["launches"]
        if [serve["serving_attention"], serve["ln_mod_matmul"]] != [depth * MESH_NFE] * 2:
            failed.append(f"rank {r} TP generate_batch launches {serve}")
        log(f"[mesh] rank {r} shapes the kernels were given: {out['shapes']}")
        for got, want, rel in zip(tp_waves[r], one, pcm_rel(tp_waves[r])):
            if got.shape != want.shape or not np.isfinite(got).all() or rel > MESH_PCM_TOL:
                failed.append(f"rank {r} TP generate_batch PCM {got.shape} vs one rank "
                              f"{want.shape}: relative L2 {rel:.3g}")
        log(f"[mesh] rank {r} TP generate_batch ({len(MESH_TEXTS)} texts, NFE {MESH_NFE}, "
            f"eager step over gloo): {out['serve tp']['audio_s']:.2f} s of audio in "
            f"{out['serve tp']['generate_batch_s']:.2f} s; PCM relative L2 vs one rank "
            + ", ".join(f"{x:.3g}" for x in pcm_rel(tp_waves[r])) + f" (tol {MESH_PCM_TOL})")
        # ZeRO-1 against the replicated run, and its resume against the run
        # (the CPU tests hold both bit for bit)
        z1, rs, dp = out["zero1"], out["zero1 resume"], out["dp"]

        def apart(steps, digest, want_steps, want_digest) -> float:
            if [s_[0] for s_ in steps] != [s_[0] for s_ in want_steps]:
                return math.inf  # the losses: a forward on the same weights
            return max([abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(steps, want_steps)]
                       + [abs(digest - want_digest) / abs(want_digest)])

        vs_dp = apart(z1["steps"], z1["digest"], dp["steps"], dp["digest"])
        vs_run = apart(rs["steps"], rs["digest"], z1["steps"][1:], z1["digest"])
        if vs_dp > MESH_RERUN_TOL or vs_run > MESH_RERUN_TOL or rs["step"] != 2:
            failed.append(f"rank {r} ZeRO-1 {z1['steps']} (parameter sum {z1['digest']}) "
                          f"against the replicated DP run {dp['steps']} ({dp['digest']}): "
                          f"{vs_dp:.3g}; its resume {rs} against the run: {vs_run:.3g}; tol "
                          f"{MESH_RERUN_TOL}")
        log(f"[mesh] rank {r} ZeRO-1: against the replicated DP run, losses equal, gradient "
            f"norms and parameter sum relative {vs_dp:.3g}; saved after step 1 in "
            f"{z1['save_s']:.2f} s; a fresh group resumed it: step 2's loss equal, its norm "
            f"and the parameter sum relative {vs_run:.3g} (tol {MESH_RERUN_TOL}); moments and "
            f"EMA held {z1['state_numel'] / 1e6:.1f} M elements of "
            f"{3 * z1['n_params'] / 1e6:.1f} M replicated")
    # AdamW's two moments and the EMA: 3 x the parameters replicated, 1.5 x at ZeRO-1
    if not all(o["zero1"]["state_numel"] <= 0.51 * 3 * o["zero1"]["n_params"] for o in ranks):
        failed.append("ZeRO-1 ranks hold more than half of the moments and EMA")
    if failed:
        raise AssertionError("[mesh] " + "; ".join(failed))
    return {k: ranks[0]["dp"]["launches"][k] for k in
            ("train_attention_fwd", "train_attention_dq", "train_attention_dkv")}


# The eval harness and the project manager (`eval/`, `profiling.py`,
# `training/project.py`, `training/finetune_gradio.py`) at F5TTS_v1_Base's
# full width and depth, random weights. NFE 16 / 8 are cuts of the eval CLI's
# default 32, for the smoke's time.
EVAL_NFE = 16
INFILL_NFE = 8
INFILL_SEEDS = 2
UI_NFE = 8
ECAPA_CARD_TOL = 1e-4  # the ECAPA embedding of a clip, card vs CPU, in units of its scale
SIM_SELF_TOL = 1e-4  # a clip's similarity to itself: 1 within this
EVAL_EXAMPLES = ROOT / "eraxvif5tts_tpu" / "infer" / "examples"
EVAL_PROMPTS = {  # the bundled clips, read as data files, with prompt texts
    "basic": ("basic/basic_ref_en.wav",
              "The lighthouse keeper wrote one line in the logbook every evening."),
    "main": ("multi/main.wav", "The old road ran past the mill and down to the river."),
    "town": ("multi/town.wav", "Market day brought the whole town into the square."),
    "country": ("multi/country.wav", "Out in the fields the wind moved through the barley."),
}
# target texts of different lengths: `get_inference_prompt`'s default buckets
# put eval_0, eval_1 and eval_2 in one batch (totals 408, 417, 418 frames,
# prompts 281, 281, 234), the others alone
EVAL_ROWS = (
    ("eval_0", "basic", "Tonight the sea was very calm."),
    ("eval_1", "basic", "The lamp kept turning all night."),
    ("eval_2", "country", "Not a single ship passed the point today."),
    ("eval_3", "main", "The supply boat arrives tomorrow morning, and the long quiet week "
                       "will finally be over."),
    ("eval_4", "town", "A bell rang twice."),
    ("eval_5", "main", "The lamp turned steadily."),
)


def held(failed: list, tag: str, name: str, check, good, planted) -> None:
    """One check and its planted fault: ``check(x)`` returns a problem (a
    string) or None; it must find none in ``good`` and one in ``planted``.
    Both readings are logged; a miss goes to ``failed``."""
    problem, control = check(good), check(planted)
    log(f"{tag} {name}: {problem or 'held'}; planted fault: {control or 'NOT REFUSED'}")
    if problem is not None:
        failed.append(f"{name}: {problem}")
    if control is None:
        failed.append(f"{name}: the planted fault passes the check")


def trace_kernels(trace_dir: Path) -> list[tuple[str, float, float]]:
    """(name, start ms, device ms) of each device kernel in the Chrome trace
    that `profiling.device_trace` wrote into ``trace_dir`` (one file)."""
    files = list(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{len(files)} trace files in {trace_dir}")
    events = json.loads(files[0].read_text())["traceEvents"]
    return [(e["name"], e["ts"] / 1e3, e.get("dur", 0.0) / 1e3) for e in events
            if e.get("cat") == "kernel"]


def busy_time(kernels: list[tuple[str, float, float]]) -> float:
    """The ms in which at least one of :func:`trace_kernels`' kernels ran:
    the union of their intervals."""
    busy, reach = 0.0, -math.inf
    for _, t, ms in sorted(kernels, key=lambda k: k[1]):
        busy += max(0.0, t + ms - max(t, reach))
        reach = max(reach, t + ms)
    return busy


@contextlib.contextmanager
def first_feed_forward_weights():
    """The planted fault of the infill arm's cast: kernel 2 given the first
    block's feed-forward weights (its bf16 copies, kept from the first call)
    in every block."""
    from eraxvif5tts_tpu_torch.models import modules

    kernel, first = modules.ln_mod_matmul, []

    def cached(x, scale, shift, weight, bias, **kwargs):
        if not first:
            first.append((weight, bias))
        return kernel(x, scale, shift, *first[0], **kwargs)

    modules.ln_mod_matmul = cached
    try:
        yield
    finally:
        modules.ln_mod_matmul = kernel


@contextlib.contextmanager
def rows_at_the_longest_length():
    """The planted per-row-length fault: every row's attention keeps the
    keys of the batch's longest row (kernel 1 still runs, given the wrong
    lengths)."""
    from eraxvif5tts_tpu_torch.models import modules

    attention = modules.dot_product_attention

    def longest(q, k, v, key_valid=None, rope=None):
        if key_valid is not None:
            key_valid = key_valid.any(dim=0, keepdim=True).expand_as(key_valid)
        return attention(q, k, v, key_valid=key_valid, rope=rope)

    modules.dot_product_attention = longest
    try:
        yield
    finally:
        modules.dot_product_attention = attention


def eval_files(dev, tmp: Path) -> dict:
    """What a user hands the eval CLI: a seeded F5TTS_v1_Base reference-format
    checkpoint and its vocab, a seeded Vocos checkpoint, and a seedtts
    metalst over the bundled clips."""
    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.models.vocos import Vocos

    files = {"ckpt": tmp / "eval_model.pt", "vocab": tmp / "eval_vocab.txt",
             "vocoder": tmp / "eval_vocos.pt", "metalst": tmp / "eval.lst"}
    save_reference_checkpoint(files["ckpt"], PRESETS["F5TTS_v1_Base"], dev)
    files["vocab"].write_text("\n".join(VOCAB_CHARS) + "\n", encoding="utf-8")
    vocos = Vocos().to(dev)
    randomize((vocos,), SEED)
    save_reference_vocoder(files["vocoder"], vocos)
    files["metalst"].write_text("".join(
        f"{utt}|{EVAL_PROMPTS[p][1]}|{EVAL_EXAMPLES / EVAL_PROMPTS[p][0]}|{text}\n"
        for utt, p, text in EVAL_ROWS), encoding="utf-8")
    return files


def check_eval_wavs(out: Path, batches, hop: int, sr: int, report: dict):
    """The eval run's outputs: each row's wav (total - ref) * hop samples,
    finite and not silent; the report's counts. A problem, or None."""
    import numpy as np

    from eraxvif5tts_tpu_torch.audio.io import read_wav

    problems, samples = [], 0
    for b in batches:
        for utt, ref, total in zip(b.utts, b.ref_mel_lens, b.total_mel_lens):
            wav, rate = read_wav(str(out / f"{utt}.wav"))
            want = (int(total) - int(ref)) * hop
            samples += wav.shape[1]
            if rate != sr or wav.shape != (1, want):
                problems.append(f"{utt}: {wav.shape[1]} samples at {rate} Hz, want {want}")
            elif not (np.isfinite(wav).all() and np.abs(wav).max() > 1e-3):
                problems.append(f"{utt}: not finite or silent (peak {np.abs(wav).max():.3g})")
    rows = sum(len(b.utts) for b in batches)
    if (report["utterances"], report["audio_seconds"]) != (rows, round(samples / sr, 2)):
        problems.append(f"report {report} for {rows} rows, {samples / sr:.2f} s")
    return "; ".join(problems) or None


def phase_eval(dev, tmp: Path) -> dict:
    """The eval harness on the card at F5TTS_v1_Base's full width and depth,
    fp32 (the eval CLI's default wrapper), random weights: the eval CLI
    (`eval_infer_batch.main`: -p, -v, -t, -o, --nfe_step 16, --vocoder_ckpt)
    over a six-line seedtts metalst of the bundled clips, wrapped in
    `RTFMeter`: every wav's length, finiteness and level and the report,
    kernel 1 fp32 launched 22 x NFE a batch; one batch of three rows at
    unequal lengths again under `profiling.device_trace` (the trace's and
    the counters' kernel 1 fp32 launches, 22 x NFE; the device's busy time
    against a CUDA-event wall), every row held to the batch through the
    plain versions and its shortest row to the same prompt run alone at
    batch 1, both within FP32_TOL; the scorers
    through `eval.__main__.main`: WER with an injected ASR whose WER is
    known, SIM through a full-size random UniSpeech ECAPA checkpoint
    (a clip's self-similarity 1, the embedding card vs CPU), UTMOS with an
    injected scorer; the infill battery's arm (`load_corpus` on a root laid
    out like the reference, `_load_arm_params`, `evaluate_arm` in bf16, one
    utterance x two seeds at NFE 8: kernels 1 and 2 22 x NFE a cell; its
    mels against the plain versions' within DIT_TOL). Each
    check beside a planted fault it must refuse. Returns the files for the
    project phase and the launches."""
    import shutil

    import numpy as np
    import torch

    from eraxvif5tts_tpu_torch import profiling
    from eraxvif5tts_tpu_torch.audio.io import read_wav, write_wav
    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.eval import __main__ as eval_cli
    from eraxvif5tts_tpu_torch.eval import ecapa_tdnn, infill
    from eraxvif5tts_tpu_torch.eval import eval_infer_batch as ib
    from eraxvif5tts_tpu_torch.eval.utils_eval import (
        PromptBatch,
        get_inference_prompt,
        get_seedtts_testset_metainfo,
        normalize_text,
        run_sim,
    )
    from eraxvif5tts_tpu_torch.models import build_backbone
    from eraxvif5tts_tpu_torch.ops.stft import MelSpectrogram
    from eraxvif5tts_tpu_torch.text.pinyin import convert_char_to_pinyin

    tag, failed = "[eval]", []
    t0 = time.perf_counter()
    files = eval_files(dev, tmp)
    gib = files["ckpt"].stat().st_size / 2**30
    log(f"{tag} reference-format F5TTS_v1_Base checkpoint ({gib:.2f} "
        f"GiB), vocab, Vocos and a {len(EVAL_ROWS)}-line metalst written in "
        f"{time.perf_counter() - t0:.1f} s")

    # the eval CLI as a user starts it; the wrapper it builds is kept
    out = tmp / "eval_out"
    built, factory = [], ib.F5TTSWrapper
    ib.F5TTSWrapper = lambda *a, **k: built.append(factory(*a, **k)) or built[-1]
    meter = profiling.RTFMeter()
    reset_serving_counts()
    try:
        meter.start_request()
        report = ib.main(["-p", str(files["ckpt"]), "-v", str(files["vocab"]),
                          "-t", str(files["metalst"]), "-o", str(out),
                          "--nfe_step", str(EVAL_NFE), "--vocoder_ckpt", str(files["vocoder"])])
        torch.cuda.synchronize()
        meter.record_chunk(int(round(report["audio_seconds"] * 24000)))
        meter.end_request()
    finally:
        ib.F5TTSWrapper = factory
    counts = serving_counts()
    wrapper = built[0]
    depth = wrapper.config.arch.depth
    batches = get_inference_prompt(get_seedtts_testset_metainfo(str(files["metalst"])),
                                   mel_fn=ib.wrapper_mel_fn(wrapper), load_wav=read_wav,
                                   tokenize=lambda t: convert_char_to_pinyin([t])[0])
    log(f"{tag} eval CLI (`eval_infer_batch.main`, F5TTSWrapper {wrapper.compute_dtype}, "
        f"depth {depth}, NFE {EVAL_NFE}): {report}; RTFMeter {meter.summary()}; "
        f"{len(batches)} batch(es): " + ", ".join(
            f"{b.utts} prompts {b.ref_mel_lens.tolist()} totals {b.total_mel_lens.tolist()}"
            for b in batches) + f"; launches {counts}")
    if wrapper.compute_dtype != "float32":
        failed.append(f"the eval CLI's wrapper serves {wrapper.compute_dtype}")
    want = {name: depth * EVAL_NFE * len(batches) if name == "serving_attention_fp32" else 0
            for name in counts}
    if counts != want:
        failed.append(f"eval CLI launches {counts}, expected {want}")
    planted = tmp / "eval_out_planted"  # one wav a hop short, one silent
    shutil.copytree(out, planted)
    short, silent = (planted / f"{EVAL_ROWS[i][0]}.wav" for i in (0, 3))
    wav, sr = read_wav(str(short))
    write_wav(str(short), wav[0, wrapper.hop_length:], sr)
    write_wav(str(silent), np.zeros_like(read_wav(str(silent))[0][0]), sr)
    held(failed, tag, "eval wavs and report", lambda d: check_eval_wavs(
        d, batches, wrapper.hop_length, wrapper.target_sample_rate, report), out, planted)

    # one batch of three rows at unequal lengths, traced: every row against
    # the batch through the plain versions, its shortest row against its
    # prompt alone at batch 1 (the same bucket, so the same noise)
    batch = max(batches, key=lambda b: len(b.utts))
    j = int(np.argmin(batch.total_mel_lens))
    if len(batch.utts) < 2 or len(set(batch.total_mel_lens.tolist())) < 2:
        raise AssertionError(f"{tag} no batch of unequal rows: {batch.total_mel_lens}")
    mels = {}
    sample = wrapper.cfm.sample
    run = "kernels"

    def recorded(*args, **kwargs):
        mel = sample(*args, **kwargs)
        mels[run] = mel.cpu()
        return mel

    wrapper.cfm.sample = recorded
    try:
        reset_serving_counts()
        trace_dir = tmp / "eval_trace"
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profiling.device_trace(str(trace_dir)) as prof:
            start.record()
            ib.run_eval_inference(wrapper, [batch], str(tmp / "eval_batch"), nfe_step=EVAL_NFE)
            end.record()
            torch.cuda.synchronize()
        run_ms = start.elapsed_time(end)
        counted = serving_counts()["serving_attention_fp32"]
        kernels = trace_kernels(trace_dir)
        mark = TRACE_MARKS["serving_attention_fp32"]
        traced = sum(1 for name, _, _ in kernels if mark in name)
        alone = PromptBatch(utts=[batch.utts[j]],
                            ref_mels=batch.ref_mels[j:j + 1, :batch.ref_mel_lens[j]],
                            ref_mel_lens=batch.ref_mel_lens[j:j + 1],
                            total_mel_lens=batch.total_mel_lens[j:j + 1],
                            final_texts=batch.final_texts[j:j + 1],
                            bucket_frames=batch.bucket_frames)
        bucket = mels["kernels"].shape[1]
        buckets, wrapper.duration_buckets = wrapper.duration_buckets, (bucket,)
        try:
            run = "alone"
            ib.run_eval_inference(wrapper, [alone], str(tmp / "eval_alone"), nfe_step=EVAL_NFE)
            run = "longest keys"
            with rows_at_the_longest_length():
                ib.run_eval_inference(wrapper, [batch], str(tmp / "eval_fault"),
                                      nfe_step=EVAL_NFE)
            run = "plain"
            with plain_serving_ops():
                plain_dir = tmp / "eval_trace_plain"
                with profiling.device_trace(str(plain_dir)):
                    ib.run_eval_inference(wrapper, [batch], str(tmp / "eval_plain"),
                                          nfe_step=EVAL_NFE)
        finally:
            wrapper.duration_buckets = buckets
    finally:
        del wrapper.cfm.sample
    totals = batch.total_mel_lens.tolist()
    n = totals[j]
    one = mels["alone"][0, :n]

    def apart(mel) -> float:
        return float(((mel[j, :n] - one).abs() / (1 + one.abs())).max())

    def from_plain(mel) -> list[float]:
        plain = mels["plain"]
        return [float(((mel[i, :t] - plain[i, :t]).abs() / (1 + plain[i, :t].abs())).max())
                for i, t in enumerate(totals)]

    def within(errs):
        err = max(errs)
        return None if err <= FP32_TOL else f"{err:.3g} beyond {FP32_TOL} * (1 + |reference|)"

    log(f"{tag} batch {batch.utts} (b={len(batch.utts)}, bucket {bucket}, totals {totals}), "
        f"max |got - reference| / (1 + |reference|): each row against the batch through the "
        f"plain versions {[f'{e:.3g}' for e in from_plain(mels['kernels'])]}, with every row "
        f"at the longest row's keys {[f'{e:.3g}' for e in from_plain(mels['longest keys'])]}; "
        f"row {batch.utts[j]} against its prompt alone at batch 1 {apart(mels['kernels']):.3g}, "
        f"at the longest keys {apart(mels['longest keys']):.3g}")
    held(failed, tag, "every batched row against the plain versions' batch", within,
         from_plain(mels["kernels"]), from_plain(mels["longest keys"]))
    held(failed, tag, "a batched row against its batch-1 run", lambda e: within([e]),
         apart(mels["kernels"]), apart(mels["longest keys"]))
    want_launches = depth * EVAL_NFE

    def launches_of(pair):
        return (None if pair == (want_launches, want_launches) else
                f"kernel 1 fp32: {pair[0]} by the counter, {pair[1]} in the trace, "
                f"want {want_launches} (22 x NFE)")

    held(failed, tag, "kernel 1 fp32 launches of one batch (counter, trace)", launches_of,
         (counted, traced),
         (counted, sum(1 for name, _, _ in trace_kernels(plain_dir) if mark in name)))
    groups, _ = device_ms_by_group(prof)
    device_ms = sum(groups.values())
    first = min(t for _, t, _ in kernels)
    span_ms = max(t + ms for _, t, ms in kernels) - first
    busy_ms = busy_time(kernels)
    log(f"{tag} the traced batch: {len(kernels)} device kernels in a {run_ms:.1f} ms CUDA-event "
        f"wall, {span_ms:.1f} ms from the first kernel's start to the last one's end; "
        f"{device_ms:.1f} ms of kernel time summed, {busy_ms:.1f} ms with the overlaps of "
        f"kernels that start before the one before them ends counted once (device busy "
        f"{100 * busy_ms / run_ms:.1f} % of the wall): "
        + ", ".join(f"{k} {v:.1f} ms ({100 * v / device_ms:.0f} %)" for k, v in groups.items()))

    # the scorers through the CLI
    metainfo = get_seedtts_testset_metainfo(str(files["metalst"]))
    truths = {utt: gt for utt, _, _, gt, _ in metainfo}

    def asr(drop_last: bool):
        def fn(path):
            utt = Path(path).stem
            words = truths[utt].split()
            if int(utt[-1]) % 2:
                words[0] = "wrong"
            return " ".join(words[:-1] if drop_last else words)
        return fn

    want_wer = float(np.mean([1 / len(normalize_text(gt)) if int(utt[-1]) % 2 else 0.0
                              for utt, gt in truths.items()]))
    wer = [eval_cli.main(["seedtts", "-m", str(files["metalst"]), "-g", str(out), "-e", "wer"],
                         asr_fn=asr(drop)) for drop in (False, True)]
    held(failed, tag, f"WER with an injected ASR (exactly {want_wer:.6f})",
         lambda s: None if s == {"n": len(metainfo), "wer_mean": want_wer} else f"{s}",
         wer[0], wer[1])

    ecapa_ckpt = tmp / "ecapa.pt"
    torch.save({"model": ecapa_tdnn.init_random_params(np.random.default_rng(SEED),
                                                       feat_dim=80)}, ecapa_ckpt)
    t0 = time.perf_counter()
    sim = eval_cli.main(["seedtts", "-m", str(files["metalst"]), "-g", str(out), "-e", "sim",
                         "--ecapa_ckpt", str(ecapa_ckpt)])
    sim_s = time.perf_counter() - t0
    rows = [json.loads(line) for line in (out / "_sim_results.jsonl").read_text().splitlines()]
    log(f"{tag} SIM through a random full-size UniSpeech ECAPA checkpoint (512 channels, "
        f"256-dim, 80 mels) on the card: {sim} in {sim_s:.2f} s")
    if sim["n"] != len(metainfo) or not all(-1.0 <= r["sim"] <= 1.0 for r in rows[:-1]):
        failed.append(f"SIM rows {rows}")
    clip = EVAL_EXAMPLES / EVAL_PROMPTS["basic"][0]
    copy_of = tmp / "clip_copy.wav"
    shutil.copyfile(clip, copy_of)
    other = EVAL_EXAMPLES / EVAL_PROMPTS["town"][0]
    embed_card = ecapa_tdnn.make_mel_embed_fn(ckpt_path=str(ecapa_ckpt), device=dev)
    held(failed, tag, f"a clip's self-similarity (1 within {SIM_SELF_TOL})",
         lambda s: None if abs(s - 1.0) <= SIM_SELF_TOL else f"{s:.6f}",
         run_sim([(str(copy_of), str(clip))], embed_card)[0]["sim"],
         run_sim([(str(other), str(clip))], embed_card)[0]["sim"])
    embed_cpu = ecapa_tdnn.make_mel_embed_fn(ckpt_path=str(ecapa_ckpt), device="cpu")
    card, cpu = embed_card(str(clip)), embed_cpu(str(clip))
    with tf32(True):
        tf32_err = float(np.abs(embed_card(str(clip)) - cpu).max() / np.abs(cpu).max())

    def against_cpu(e):
        err = float(np.abs(e - cpu).max() / np.abs(cpu).max())
        return None if err <= ECAPA_CARD_TOL else f"{err:.3g} of scale beyond {ECAPA_CARD_TOL}"

    log(f"{tag} ECAPA embedding card vs CPU: "
        f"{float(np.abs(card - cpu).max() / np.abs(cpu).max()):.3g} of scale; with TF32 on "
        f"{tf32_err:.3g} (logged)")
    held(failed, tag, "the ECAPA embedding, card vs CPU", against_cpu, card,
         embed_cpu(str(other)))

    names = sorted(p.name for p in out.glob("*.wav"))
    seconds = {name: read_wav(str(out / name))[0].shape[1] / 24000 for name in names}
    want_mos = float(np.mean([1.0 + seconds[name] for name in names]))
    utmos = [eval_cli.main(["utmos", "-g", str(out)], utmos_fn=fn) for fn in (
        lambda p: 1.0 + seconds[Path(p).name], lambda p: 1.0 + seconds[Path(p).name] * 0.5)]
    held(failed, tag, "UTMOS with an injected scorer",
         lambda s: None if s == {"n": len(names), "utmos_mean": want_mos} else f"{s}",
         utmos[0], utmos[1])

    # the infill battery's arm, bf16
    root = tmp / "reference"
    corpus_wav = root / infill.CORPUS[0][0]
    corpus_wav.parent.mkdir(parents=True)
    shutil.copyfile(clip, corpus_wav)
    mel = MelSpectrogram()
    corpus = infill.load_corpus(
        lambda w: mel(torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(dev)).cpu(),
        24000, 256, root=str(root))
    vocab = infill.corpus_vocab(corpus)
    cfg = PRESETS["F5TTS_v1_Base"]
    backbone = build_backbone(cfg, len(vocab)).to(dev)
    randomize((backbone,), SEED + 4)
    arm_ckpt = tmp / "infill_arm.pt"
    save_reference_checkpoint_of(arm_ckpt, backbone)
    del backbone
    cfm, arm_depth = infill._load_arm_params(str(arm_ckpt), cfg, vocab, torch.bfloat16, dev)
    arm_mels, arm_sample = {}, cfm.sample

    def arm_recorded(*args, **kwargs):
        mel = arm_sample(*args, **kwargs)
        arm_mels.setdefault(run, []).append(mel[0, :corpus[0]["mel_spec"].shape[0]].float().cpu())
        return mel

    cfm.sample = arm_recorded
    try:
        run = "kernels"
        reset_serving_counts()
        t0 = time.perf_counter()
        cells = infill.evaluate_arm(cfm, corpus, vocab, INFILL_SEEDS, INFILL_NFE, arm="teacher")
        arm_s = time.perf_counter() - t0
        arm_counts = serving_counts()
        run = "one seed"
        cell_noise = infill._cell_noise
        infill._cell_noise = lambda utt, seed, n_frames, n_mels, device: cell_noise(
            utt, 0, n_frames, n_mels, device)
        try:
            one_seed = infill.evaluate_arm(cfm, corpus, vocab, INFILL_SEEDS, INFILL_NFE, arm="c")
        finally:
            infill._cell_noise = cell_noise
        run = "plain"
        with plain_serving_ops():
            infill.evaluate_arm(cfm, corpus, vocab, INFILL_SEEDS, INFILL_NFE, arm="plain")
        run = "block 0"
        with first_feed_forward_weights():
            infill.evaluate_arm(cfm, corpus, vocab, INFILL_SEEDS, INFILL_NFE, arm="c")
    finally:
        del cfm.sample
    log(f"{tag} infill arm ({len(corpus)} utterance, {corpus[0]['mel_spec'].shape[0]} frames, "
        f"vocab {len(vocab)}, depth {arm_depth}, bf16) x {INFILL_SEEDS} seeds at NFE "
        f"{INFILL_NFE} in {arm_s:.2f} s: {cells}; launches {arm_counts}")
    metrics = ("infill_mel_l1", "ltas_corr_gen", "ltas_corr_full")

    def cells_sound(cs):
        if not all(math.isfinite(c[m]) for c in cs for m in metrics):
            return "a cell is not finite"
        if [c[m] for m in metrics for c in cs[:1]] == [c[m] for m in metrics for c in cs[1:2]]:
            return "the two seeds give the same cell"
        return None

    held(failed, tag, "the infill cells (finite, the seeds differ)", cells_sound, cells,
         one_seed)

    def arm_from_plain(name) -> float:
        return max(float((got - want).abs().max() / want.abs().max())
                   for got, want in zip(arm_mels[name], arm_mels["plain"]))

    def arm_within(err):
        ok = err <= DIT_TOL and all(torch.isfinite(m).all() for m in arm_mels["kernels"])
        return None if ok else f"{err:.3g} of scale beyond {DIT_TOL}"

    arm_err, arm_control = arm_from_plain("kernels"), arm_from_plain("block 0")
    log(f"{tag} infill arm's mels (bf16, kernels 1 and 2 with the feed-forward's bf16 "
        f"copies) against the plain versions: {arm_err:.3g} of scale; with kernel 2 given "
        f"block 0's weights in every block {arm_control:.3g}")
    held(failed, tag, "the infill arm's mels against the plain versions", arm_within,
         arm_err, arm_control)
    want_arm = {name: arm_depth * INFILL_NFE * INFILL_SEEDS
                if name in ("serving_attention", "ln_mod_matmul") else 0 for name in arm_counts}
    if arm_counts != want_arm:
        failed.append(f"infill arm launches {arm_counts}, expected {want_arm}")
    del cfm, wrapper, built
    if failed:
        raise AssertionError(f"{tag} " + "; ".join(failed))
    return {"ckpt": files["ckpt"], "vocab": files["vocab"],
            "eval kernel 1 fp32": counts["serving_attention_fp32"],
            "infill kernels 1 / 2 bf16": (arm_counts["serving_attention"],
                                          arm_counts["ln_mod_matmul"])}


def start_training_runs(tmp: Path) -> list:
    """`TrainingProcess` runs of the port's CLI for the project phase,
    started early (a subprocess takes seconds to import torch): `finetune
    --help` and, the planted fault, `finetune --no-such-flag`. The project
    phase waits for both."""
    from eraxvif5tts_tpu_torch.training.project import TrainingProcess

    runs = []
    for args, name in ((["finetune", "--help"], "train_help.log"),
                       (["finetune", "--no-such-flag"], "train_bad.log")):
        run = TrainingProcess()
        run.start(args, log_path=str(tmp / name))
        runs.append((run, tmp / name, time.perf_counter()))
    return runs


def phase_project(dev, tmp: Path, files: dict, runs: list) -> dict:
    """The fine-tuning project manager on the card: a `ProjectStore` in a
    temporary directory (create, the metadata, `vocab_check` against the
    eval phase's vocab), `vocab_extend` of the eval phase's full-size
    checkpoint (the embedding's new rows, the old rows bit for bit, a strict
    load into the port's DiT), `prune_checkpoint_to_ema` of a trainer
    checkpoint (the EMA weights bit for bit, a strict load),
    `settings_to_cli_args` parsed by the port's finetune parser,
    `TrainingProcess.start(["finetune", "--help"])` exiting 0,
    `system_stats` naming the card and its memory, and `ui_test_infer` at
    NFE 8 in bf16 on the card (kernels 1 and 2 launched). Each check beside
    a planted fault it must refuse. Returns the launches of
    `ui_test_infer`."""
    import shutil

    import numpy as np
    import torch

    from eraxvif5tts_tpu_torch.compression.convert import (
        infer_text_num_embeds,
        load_state_dict,
        reference_backbone_state_dict,
    )
    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.models import build_backbone
    from eraxvif5tts_tpu_torch.training import cli
    from eraxvif5tts_tpu_torch.training import finetune_gradio as ui
    from eraxvif5tts_tpu_torch.training.project import (
        ProjectStore,
        settings_to_cli_args,
        system_stats,
    )

    tag, failed = "[project]", []
    store = ProjectStore(str(tmp / "projects"))
    _, project = ui.ui_create_project(store, "smoke", "char")
    proj = Path(store.path(project))
    texts = ("Xin chào các bạn", "Tôi là một người máy", "hello world")
    (proj / "dataset" / "metadata.csv").write_text(
        "".join(f"wavs/{i}.wav|{t}\n" for i, t in enumerate(texts)), encoding="utf-8")
    shutil.copyfile(files["vocab"], proj / "vocab.txt")
    known = set(VOCAB_CHARS)
    want_missing = sorted({c for t in texts for c in t if c not in known})
    missing, status = ui.ui_vocab_check(store, project)
    planted_vocab = tmp / "covering_vocab"
    planted_vocab.mkdir()
    planted_store = ProjectStore(str(planted_vocab))
    _, planted_project = ui.ui_create_project(planted_store, "smoke", "char")
    shutil.copyfile(proj / "dataset" / "metadata.csv",
                Path(planted_store.path(planted_project)) / "dataset" / "metadata.csv")
    (Path(planted_store.path(planted_project)) / "vocab.txt").write_text(
        "\n".join(VOCAB_CHARS) + "\n" + want_missing[0] + "\n", encoding="utf-8")
    held(failed, tag, f"vocab_check ({status})",
         lambda m: None if m.split() == want_missing else f"missing {m.split()}", missing,
         ui.ui_vocab_check(planted_store, planted_project)[0])

    extended = tmp / "extended.pt"
    t0 = time.perf_counter()
    msg = ui.ui_vocab_extend(store, project, missing, str(files["ckpt"]), str(extended))
    extend_s = time.perf_counter() - t0
    before = load_state_dict(str(files["ckpt"]))
    after = load_state_dict(str(extended))
    key = "transformer.text_embed.text_embed.weight"
    old, new = before[f"ema_model.{key}"], after[key]
    log(f"{tag} {msg} in {extend_s:.2f} s: text embedding {old.shape} -> {new.shape}")
    if not (new.shape == (old.shape[0] + len(want_missing), old.shape[1])
            and np.array_equal(new[:old.shape[0]], old)):
        failed.append(f"the extended embedding {new.shape} from {old.shape}")
    cfg = PRESETS["F5TTS_v1_Base"]

    def loads_strict(path, n_text: int):
        """None if ``path`` loads strict into a DiT of ``n_text`` text rows."""
        with torch.device("meta"):
            dit = build_backbone(cfg, n_text)
        try:
            dit.load_state_dict(reference_backbone_state_dict(str(path)), strict=True,
                                assign=True)
        except RuntimeError as e:
            return f"{str(e).splitlines()[0]} ..."
        return None

    n_text = infer_text_num_embeds(after)
    held(failed, tag, f"the extended checkpoint loads strict into a DiT of {n_text} text rows",
         lambda path: loads_strict(path, n_text), extended, files["ckpt"])

    # a trainer checkpoint: model, EMA (one storage each), optimizer state
    ema = {k[len("ema_model."):]: torch.from_numpy(v) for k, v in before.items()
           if k.startswith("ema_model.")}
    model = dict(ema)
    model["transformer.proj_out.bias"] = ema["transformer.proj_out.bias"] + 1.0
    trainer_ckpt, pruned = tmp / "trainer_model_3.pt", tmp / "pruned.pt"
    torch.save({"model_state_dict": model,
                "ema_model_state_dict": {**{f"ema_model.{k}": v for k, v in ema.items()},
                                         "initted": torch.tensor(True),
                                         "step": torch.tensor(3)},
                "optimizer_state_dict": {"state": {0: {"exp_avg": torch.zeros(4)}},
                                         "param_groups": [{"lr": 1e-5}]},
                "update": 3}, trainer_ckpt)
    t0 = time.perf_counter()
    n_kept = ui.ui_prune(str(trainer_ckpt), str(pruned))
    prune_s = time.perf_counter() - t0
    kept = reference_backbone_state_dict(str(pruned))
    load_problem = loads_strict(pruned, infer_text_num_embeds(before))

    def equals(weights):
        wrong = [k for k, v in kept.items() if not torch.equal(v, weights[f"transformer.{k}"])]
        return None if not wrong and len(kept) == len(weights) else f"differs at {wrong[:3]}"

    log(f"{tag} {n_kept} ({prune_s:.2f} s), {len(kept)} tensors; strict load: "
        f"{load_problem or 'loads'}")
    if load_problem is not None:
        failed.append(f"the pruned checkpoint does not load strict: {load_problem}")
    held(failed, tag, "the pruned checkpoint holds the EMA weights bit for bit", equals, ema,
         model)

    settings = {**store.load_settings(project), "epochs": 2, "file_checkpoint_train":
                str(extended)}
    argv = settings_to_cli_args(project, settings, store.root)

    def parses(args):
        try:
            a = cli.finetune_parser().parse_args(args[1:])
        except SystemExit as e:
            return f"the parser exits {e.code}"
        got = (a.dataset_name, a.pretrain, a.epochs, a.compute_dtype, a.checkpoint_dir)
        want = (project, str(extended), 2, "bfloat16", str(proj / "ckpts"))
        return None if got == want else f"{got} != {want}"

    with open(os.devnull, "w") as devnull, contextlib.redirect_stderr(devnull):
        held(failed, tag, "settings_to_cli_args through the port's finetune parser", parses,
             argv, argv + ["--no-such-flag"])

    stats = system_stats()
    name = torch.cuda.get_device_name(0)
    total = torch.cuda.get_device_properties(0).total_memory

    def names_the_card(s):
        ok = (any(name in d for d in s.get("devices", []))
              and s.get("device_memory", {}).get("total_bytes") == total)
        return None if ok else f"devices {s.get('devices')}, memory {s.get('device_memory')}"

    held(failed, tag, f"system_stats names {name} and its {total / 2**30:.1f} GiB",
         names_the_card, stats, {k: v for k, v in stats.items() if k != "devices"})

    reset_serving_counts()
    ref_clip = EVAL_EXAMPLES / EVAL_PROMPTS["basic"][0]
    t0 = time.perf_counter()
    sr, wav = ui.ui_test_infer(store, project, str(extended), str(ref_clip),
                               EVAL_PROMPTS["basic"][1], "Tôi là một người máy, hello world.",
                               nfe=UI_NFE)
    ui_s = time.perf_counter() - t0
    counts = serving_counts()
    log(f"{tag} ui_test_infer (the extended checkpoint, the project's vocab, bf16, NFE "
        f"{UI_NFE}, wrapper built and graphs captured inside) in {ui_s:.2f} s: "
        f"{len(wav) / sr:.2f} s of audio at {sr} Hz; launches {counts}")

    def sound(w):
        if len(w) < sr // 2 or not np.isfinite(w).all() or np.abs(w).max() <= 1e-3:
            return f"{len(w)} samples, peak {np.abs(w).max():.3g}"
        return None

    held(failed, tag, "ui_test_infer's wave (length, finite, not silent)", sound, wav,
         np.concatenate([wav, [np.nan]]))
    depth = cfg.arch.depth
    if not (counts["serving_attention"] > 0 and counts["serving_attention"] % depth == 0
            and counts["ln_mod_matmul"] == counts["serving_attention"]
            and counts["serving_attention_fp32"] == 0):
        failed.append(f"ui_test_infer launches {counts}")

    for run, _, started in runs:
        run.proc.wait(timeout=max(1.0, 180 - (time.perf_counter() - started)))
    (help_run, help_log, started), (bad_run, bad_log, _) = runs
    log(f"{tag} TrainingProcess `finetune --help` and `finetune --no-such-flag` (started "
        f"before the eval phase): exit codes {help_run.proc.returncode}, "
        f"{bad_run.proc.returncode}; done {time.perf_counter() - started:.1f} s after the start")
    held(failed, tag, "TrainingProcess runs the port's finetune CLI",
         lambda p: None if p[0] == 0 and "usage: eraxvif5tts-torch-finetune" in p[1].read_text()
         else f"exit {p[0]}: {p[1].read_text()[-300:]!r}",
         (help_run.proc.returncode, help_log), (bad_run.proc.returncode, bad_log))
    if failed:
        raise AssertionError(f"{tag} " + "; ".join(failed))
    return {"ui_test_infer kernels 1 / 2 bf16": (counts["serving_attention"],
                                                 counts["ln_mod_matmul"])}


def timed(tag: str, phase, *args, **kwargs):
    """``phase(*args, **kwargs)`` (a phase or a check), its wall logged."""
    t0 = time.perf_counter()
    result = phase(*args, **kwargs)
    log(f"{tag} phase done in {time.perf_counter() - t0:.1f} s")
    return result


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
    from eraxvif5tts_tpu_torch.configs import PRESETS

    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernel_results = timed("[kernels]", phase_kernels, dev)
    wrapper, ref, launches = timed("[main]", phase_main, dev)
    timed("[server]", phase_server, wrapper, ref)
    timed("[http]", phase_http, wrapper)
    timed("[edit]", phase_edit, wrapper, dev)
    bigvgan_launches = timed("[bigvgan]", phase_bigvgan, wrapper, dev)
    cfg = wrapper.config
    with tempfile.TemporaryDirectory() as tmp:
        mmdit_ckpt = Path(tmp) / "mmdit.pt"
        mmdit_cfg = cut_depth(PRESETS["F5TTS_v1_MMDiT"], MMDIT_DEPTH)
        launches["serving_attention_joint"] = timed("[mmdit]", phase_mmdit, dev, mmdit_cfg,
                                                    ckpt=mmdit_ckpt)
        fp32_rows, fp32_launches = timed("[fp32]", phase_fp32, wrapper, dev, mmdit_ckpt)
        timed("[bench]", phase_bench)
        mmdit_ff, ff_err = timed("[mmdit-int8]", phase_int8, dev, mmdit_cfg, "[mmdit-int8]",
                                 mmdit_ckpt, turns=1)
    kernel_results["int8_ff"]["max_abs_err"] = max(kernel_results["int8_ff"]["max_abs_err"],
                                                   ff_err)
    kernel_results.update(fp32_rows)
    launches.update(fp32_launches)
    del wrapper, ref
    launches["int8_ff"], ff_err = timed("[int8]", phase_int8, dev, cfg)
    kernel_results["int8_ff"]["max_abs_err"] = max(kernel_results["int8_ff"]["max_abs_err"],
                                                   ff_err)
    launches.update(timed("[train]", phase_train, dev))
    timed("[train-cli]", phase_train_cli, dev, smi)
    fp32_train_rows, fp32_train_launches = timed("[train-fp32]", phase_train_fp32, dev)
    kernel_results.update(fp32_train_rows)
    launches.update(fp32_train_launches)
    d128_rows, d128_launches = timed("[d128]", phase_d128, dev)
    kernel_results.update(d128_rows)
    launches.update(d128_launches)
    d256_rows, d256_launches = timed("[d256]", phase_d256, dev)
    kernel_results.update(d256_rows)
    launches.update(d256_launches)
    launches.update(timed("[mmdit-train]", phase_mmdit_train, dev,
                          cut_depth(PRESETS["F5TTS_v1_MMDiT"], MMDIT_TRAIN_DEPTH)))
    with tempfile.TemporaryDirectory() as tmp:
        e2_ckpt = Path(tmp) / "e2tts_base.pt"
        e2_cfg = cut_depth(PRESETS["E2TTS_Base"], E2TTS_DEPTH)
        launches.update(timed("[e2tts]", phase_e2tts, dev, e2_cfg, ckpt=e2_ckpt))
        # one round, as [mmdit-int8]: the whole smoke passed 850 s on a slow host
        launches["int8_ff_ffmult4"], ff_err = timed("[e2tts-int8]", phase_int8, dev, e2_cfg,
                                                    "[e2tts-int8]", e2_ckpt, turns=1)
    row = kernel_results["int8_ff_ffmult4"]
    row["max_abs_err"] = max(row["max_abs_err"], ff_err)
    compress = timed("[compress]", phase_compress, dev)
    mesh_launches = timed("[mesh]", phase_mesh, dev)
    with tempfile.TemporaryDirectory() as tmp:
        runs = start_training_runs(Path(tmp))
        try:
            evaluated = timed("[eval]", phase_eval, dev, Path(tmp))
            managed = timed("[project]", phase_project, dev, Path(tmp), evaluated, runs)
        finally:
            for run, _, _ in runs:
                run.stop()
    idle = {path: [k for k, v in counts.items() if v <= 0] for path, counts in compress.items()}
    if any(idle.values()):
        raise AssertionError(f"kernels never launched on the compress path: {idle}")
    log(f"[compress] launches by path: {compress}")
    log(f"[mesh] rank 0's training kernel launches in the DP 2 steps: {mesh_launches}")
    log(f"[eval] launches: the eval CLI's batches {evaluated['eval kernel 1 fp32']} of "
        f"kernel 1 fp32; the infill arm {evaluated['infill kernels 1 / 2 bf16']} of kernels 1 "
        f"and 2 bf16; [project] ui_test_infer {managed['ui_test_infer kernels 1 / 2 bf16']}")
    log(f"[bigvgan] launches: {bigvgan_launches}; [mmdit] kernel 1 without rotary: "
        f"{launches['serving_attention_joint']}; [fp32] kernel 1 fp32: {fp32_launches}; "
        f"[mmdit-int8] kernel 5 in the fused batch call: {mmdit_ff}")
    kernels = [
        *(dict(name=name, route="cuda",
               source="eraxvif5tts_tpu_torch/csrc/serving_attention.cu",
               replaces="eraxvif5tts_tpu/ops/serving_attention.py:121",
               launches=launches[name], **kernel_results[name])
          for name in ("serving_attention", "serving_attention_norope",
                       "serving_attention_joint")),
        *(dict(name=name, route="cuda",
               source="eraxvif5tts_tpu_torch/csrc/serving_attention_fp32.cu",
               replaces="eraxvif5tts_tpu/ops/serving_attention.py:121",
               launches=launches[name], **kernel_results[name])
          for name in ("serving_attention_fp32", "serving_attention_fp32_norope")),
        *(dict(name=name, route="cuda",
               source="eraxvif5tts_tpu_torch/csrc/ln_mod_matmul.cu",
               replaces="eraxvif5tts_tpu/ops/fused_matmul.py:68",
               launches=launches[name], **kernel_results[name])
          for name in ("ln_mod_matmul", "ln_mod_matmul_rms")),
        *(dict(name=name, route="cuda", source="eraxvif5tts_tpu_torch/csrc/int8_ff.cu",
               replaces="eraxvif5tts_tpu/ops/quant_ff.py:101", launches=launches[name],
               **kernel_results[name])
          for name in INT8_FF_WIDTHS),
        dict(name="matmul_gate_res", route="cuda",
             source="eraxvif5tts_tpu_torch/csrc/matmul_gate_res.cu",
             replaces="eraxvif5tts_tpu/ops/fused_matmul.py:99", **kernel_results["matmul_gate_res"]),
        *(dict(name=name, route="cuda",
               source="eraxvif5tts_tpu_torch/csrc/train_attention.cu",
               replaces=f"eraxvif5tts_tpu/ops/train_attention.py:{line}",
               launches=launches[name], **kernel_results[name])
          for name, line in (("train_attention_fwd", 104), ("train_attention_dq", 150),
                             ("train_attention_dkv", 190))),
        *(dict(name=name, route="cuda",
               source="eraxvif5tts_tpu_torch/csrc/train_attention_fp32.cu",
               replaces=f"eraxvif5tts_tpu/ops/train_attention.py:{line}",
               launches=launches[name], **kernel_results[name])
          for name, line in (("train_attention_fp32_fwd", 104), ("train_attention_fp32_dq", 150),
                             ("train_attention_fp32_dkv", 190))),
        *(dict(name=f"{prefix}_{name}", route="cuda",
               source=f"eraxvif5tts_tpu_torch/csrc/{source}",
               replaces=f"eraxvif5tts_tpu/ops/train_attention.py:{line}",
               launches=launches[f"{prefix}_{name}"], **kernel_results[f"{prefix}_{name}"])
          for prefix, source in (("train_attention_joint", "train_attention.cu"),
                                 ("train_attention_fp32_joint", "train_attention_fp32.cu"),
                                 ("train_attention_d128", "train_attention.cu"),
                                 ("train_attention_fp32_d128", "train_attention_fp32.cu"))
          for name, line in (("fwd", 104), ("dq", 150), ("dkv", 190))),
        *(dict(name=name, route="cuda", source=f"eraxvif5tts_tpu_torch/csrc/{source}",
               replaces="eraxvif5tts_tpu/ops/serving_attention.py:121",
               launches=launches[name], **kernel_results[name])
          for name, source in (("serving_attention_d128", "serving_attention.cu"),
                               ("serving_attention_fp32_d128", "serving_attention_fp32.cu"))),
        # kernel 6, the library flash kernel, at d = 256: its serving role and
        # its dropout-free training role
        *(dict(name=name, route="cuda", source=f"eraxvif5tts_tpu_torch/csrc/{source}",
               replaces="eraxvif5tts_tpu/ops/attention.py:38", launches=launches[name],
               **kernel_results[name])
          for name, source in (("serving_attention_d256_norope", "serving_attention.cu"),
                               ("serving_attention_fp32_d256_norope",
                                "serving_attention_fp32.cu"),
                               ("train_attention_d256_fwd", "train_attention.cu"),
                               ("train_attention_d256_dq", "train_attention.cu"),
                               ("train_attention_d256_dkv", "train_attention.cu"),
                               ("train_attention_fp32_d256_fwd", "train_attention_fp32.cu"),
                               ("train_attention_fp32_d256_dq", "train_attention_fp32.cu"),
                               ("train_attention_fp32_d256_dkv", "train_attention_fp32.cu"))),
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
