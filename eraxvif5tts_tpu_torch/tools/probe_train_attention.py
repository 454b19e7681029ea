"""Digests and times of the attention kernels of one tree of the repository,
to compare two trees (a commit and its parent) on one card.

    python3 eraxvif5tts_tpu_torch/tools/probe_train_attention.py TREE [--step] [--serve]
    python3 eraxvif5tts_tpu_torch/tools/probe_train_attention.py TREE --fp32 [--against OTHER]
    python3 eraxvif5tts_tpu_torch/tools/probe_train_attention.py TREE --fp32 --head-dim 128|256 \
        [--against OTHER] [--backward | --forward]
    python3 eraxvif5tts_tpu_torch/tools/probe_train_attention.py TREE --fp32 --head-dim 64 \
        --forward [--against OTHER]
    python3 eraxvif5tts_tpu_torch/tools/probe_train_attention.py TREE --fp32 --head-dim 128|256 \
        --train-step REPS
    python3 eraxvif5tts_tpu_torch/tools/probe_train_attention.py TREE --head-dim 64|128|256 \
        [--against OTHER] [--no-digests] [--train-step REPS | --loss-seeds SEEDS]

TREE is the root of a checkout (this one: `.`; another commit: unpack it
with `git archive` into a directory `.gitignore` lists). The package and
`chip_smoke.py` are imported from TREE, the kernels are built there, and
every line printed starts with TREE. Run the trees in turns inside one call
(parent, change, change, parent): a card's clocks and power limit differ
between calls. Printed:

- the card's name and power limit and the build's register report;
- sha256 digests of the forward's O and LSE and of dq, dk, dv on seeded
  inputs (b = 2, n = 4096, lens [4096, 4059]; b = 3, n = 192, lens
  [192, 0, 155]), at dropout 0.1 and 0: equal digests mean equal bits;
- median CUDA-event times of the three training kernels at b = 2, h = 16,
  n = 4096 and 1024, the second sample masked by 37 keys, at keep = 1 and
  dropout 0.1;
- the same of the training forward and of the serving attention with and
  without fused rotary at n = 1088 and 4096, beside the library's
  `scaled_dot_product_attention` without a mask and with the key mask;
- with `--step`, the tree's own `chip_smoke.phase_train`: the train step's
  wall at 9 x 4096 frames and the peak memory;
- with `--serve`, a bf16 `F5TTSWrapper` at F5TTS_v1_Base width on seeded
  random weights: three `generate`s of the smoke's first text (wall and
  realtime factor at batch 1) and three `generate_batch`es of its eight
  texts (seconds of audio per wall second), at NFE 32 after a warm-up of each.

With `--fp32`, the fp32 kernels instead (4a, 4b, 4c in
`csrc/train_attention_fp32.cu`, kernel 1 in `csrc/serving_attention_fp32.cu`):

- the register report of the fp32 forward instantiations (kernel 4a's at
  dropout on and off, kernel 1's with and without rotary) of TREE's build
  and, with `--against`, of OTHER's;
- digests of O, LSE, dq, dk, dv on the seeded inputs above in fp32, and the
  largest error of each against the plain version (TF32 off; O in units of
  1 + |plain|, the gradients of their scale);
- median CUDA-event times at b = 2, h = 16, n = 4096 and 1024 (lens [n,
  n - 37]) at keep = 1 and dropout 0.1 of the forward, dq and dk/dv, beside
  their bounds at the 3xTF32 rate (495 / 3 TFLOP/s) and the FFMA rate (67
  TFLOP/s), the plain version's backward and fp32
  `scaled_dot_product_attention`'s backward (TF32 off, no mask);
- kernel 1 fp32 at b = 2, h = 16, n = 1088 (lens [1051, 0]), 4096 ([4096,
  4059]) and 6144 ([6144, 3099]), with and without rotary, beside its
  bounds and fp32 `scaled_dot_product_attention` with the key mask; and at
  n = 1088 with h = 16 against h = 15 (2.06 against 1.93 waves of blocks),
  what the last, part-filled wave costs;
- with `--against OTHER` (another tree, its kernels built from its own
  `csrc/` and loaded into this process beside TREE's): OTHER's fp32
  forward, dq, dk/dv and kernel 1 on the same tensors, timed in turns with
  TREE's (OTHER, TREE, TREE, OTHER), and the largest difference between the
  two trees' O, LSE and gradients (the digests' inputs) and kernel 1
  outputs;
- the rates behind the backward's design (`tools/tf32_rates.cu`, built
  here): `mma.sync.m16n8k8` TF32 in TFLOP/s with 1, 4 and 8 independent
  accumulators a warp, at the kernels' occupancy (two blocks of 128
  threads an SM) and at four blocks of 256, and `cvt.rna.tf32.f32`, the
  same rounding in two integer operations, and an fp32 multiply, in
  operations a second.

With `--fp32 --head-dim D` (128 or 256; h = 1024 / D, the DiT's width of
1024 in heads of D, so that b h D = 2048 at b = 2 and the work equals the
d = 64 rows' at h = 16), the wide fp32 kernels instead:

- the register report of both builds' fp32 forward and backward
  instantiations, and the digests above (O, LSE, dq, dk, dv) at d = 64
  (h = 16), d = 128 (h = 8) and d = 256 (h = 4; with `--against`, equal
  digests and a difference of 0 mean those kernels give OTHER's bits);
- at d = D, dq and dk/dv at b = 2, n = 4096 (lens [4096, 4059]) and 6144
  (lens [6144, 6107]) at keep = 1 and dropout 0.1, on the TREE forward's
  LSE: each tree's largest dq, dk and dv error against the plain version's
  autograd (in units of max |plain|), the largest difference between the
  trees, and median CUDA-event times in turns (OTHER, TREE, TREE, OTHER)
  beside their 3xTF32 bounds, the plain version's backward (all three
  gradients, at the same dropout) and fp32 `scaled_dot_product_attention`'s
  backward (TF32 off, no mask) in the same turns;
- at d = D, kernel 1 fp32 at b = 2, n = 1088 (lens [1051, 0]), n = 1024
  (lens [1024, 987]) and n = 576 (lens [576, 576]: the bucket of `chip_smoke`'s
  `[d128]` / `[d256]` `generate`, b h n / 64 blocks under one wave at d = 256),
  without rotary and at d = 128 with it, and kernel 4a
  fp32 at n = 4096 (lens [4096, 4059]) at keep = 1 and dropout 0.1: each
  tree's largest error against the plain version (O in units of 1 + |plain|,
  the LSE absolute), the largest difference between the trees' O and LSE,
  and median CUDA-event times in turns (OTHER, TREE, TREE, OTHER) beside
  the 3xTF32 bound and fp32 `scaled_dot_product_attention` (TF32 off; the
  key mask when serving, none in training) in the same turns;
- the wave tail: n = 1088 against 1024 gives b h n / 64 blocks of 64 rows
  at one block an SM, over the card's SMs: what the part-filled last wave
  costs beside the work's ratio.

With `--backward` as well, it stops after the backward at d = D (the
register report, the digests, dq and dk/dv in turns): the forward is not
timed; with `--forward` the backward is not timed (and D may be 64: kernel 1
fp32 at h = 16 with and without rotary, beside fp32 SDPA with the key mask
on q and k rotated outside it). With `--train-step REPS` instead, only TREE's fp32 CFM step of the
smoke's `[d128]` / `[d256]` DiT (`chip_smoke.train_at`: a warm-up and a
timed `Trainer.train_step` at 2 x 4096, dropout 0.1), REPS times; run the
trees in turns, one process each.

With `--head-dim D` alone (64, 128 or 256; h = 1024 / D), the bf16 forward core
(kernel 4a and kernel 1, `csrc/flash_forward.cuh`) instead:

- ptxas's report of both builds' forward instantiations at d = 64, 128 and
  256: registers, spills and every note (`chip_smoke.forward_build_notes`);
- digests of O, LSE, dq, dk, dv at d = 64, 128 and 256 on the seeded inputs
  above (bf16), each gradient's relative L2 error against the plain
  version's autograd and, with `--against`, the largest differences from
  OTHER's (0 and equal digests: OTHER's bits);
- at d = D, kernel 4a at b = 2, n = 4096 (lens [4096, 4059]) and 6144
  (lens [6144, 6107]) at keep = 1 and dropout 0.1, and kernel 1 at n =
  1088 (lens [1051, 0]) and 4096 (lens [4096, 4059]), with fused rotary
  and without at d = 64 and 128, without at 256: each tree's largest O error
  against the plain version (in units of 1 + |plain|) and LSE error, the
  trees' largest differences, times in turns (OTHER, TREE, TREE, OTHER:
  each the median over 7 CUDA-event spans of 100 calls back to back, a
  span over 100) beside the bound and `scaled_dot_product_attention` as
  the smoke times it (heads second, inputs that take a gradient, the
  dispatcher's backend: cuDNN on the card's torch) and on its flash backend
  (no mask; q and k rotated outside it for rotary) in the same turns;
- with `--train-step REPS`, only TREE's bf16 CFM step of the smoke's
  `[d128]` / `[d256]` DiT at 2 x 4096, dropout 0.1, REPS times;
- with `--loss-seeds SEEDS` (D = 128 or 256), only the readings of the
  smoke's bf16 CFM-loss check at dropout 0.1 (`chip_smoke.train_at`'s DiT,
  `hold_loss_against_plain` with no limit held) on the loss batches of
  SEEDS seeds from the smoke's own on: each seed's loss error and its
  wrong-keys control, then the largest error and the smallest control.
"""

from __future__ import annotations

import hashlib
import re
import sys
from pathlib import Path


def digest(t) -> str:
    import torch

    raw = t.contiguous().cpu().view(-1).view(dtype=torch.uint8).numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def main(argv: list[str]) -> int:
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(argv[0]).resolve()
    tag = f"[{argv[0]}]"
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    if Path(cs.__file__).resolve().parent != tree:
        raise RuntimeError(f"chip_smoke was imported from {cs.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        print("probe_train_attention: no CUDA device", file=sys.stderr)
        return 2
    log = cs.log
    cs.log = lambda *a: log(tag, *a)
    cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1234)

    def inputs(b, n, lens):
        tensors = [torch.randn((b, n, 16, 64), generator=g, device=dev).bfloat16()
                   for _ in range(4)]
        return tensors, torch.tensor(lens, dtype=torch.int32, device=dev)

    if "--head-dim" in argv and "--fp32" not in argv:
        d = int(argv[argv.index("--head-dim") + 1])
        if "--train-step" in argv:
            train_steps(cs, dev, d, int(argv[argv.index("--train-step") + 1]), "bf16")
        elif "--loss-seeds" in argv:
            loss_seeds(cs, dev, d, int(argv[argv.index("--loss-seeds") + 1]))
        else:
            other = argv[argv.index("--against") + 1] if "--against" in argv else None
            wide_bf16(cs, dev, g, other, d, "--no-digests" not in argv)
        return 0
    if "--fp32" in argv[1:]:
        other = argv[argv.index("--against") + 1] if "--against" in argv else None
        if "--head-dim" in argv:
            d = int(argv[argv.index("--head-dim") + 1])
            if "--train-step" in argv:
                train_steps(cs, dev, d, int(argv[argv.index("--train-step") + 1]))
            else:
                wide_fp32(cs, dev, g, other, d, "--backward" in argv, "--forward" in argv)
            return 0
        fp32(cs, dev, g, other)
        tf32_rates(cs, dev)
        return 0
    for b, n, lens_list in ((2, 4096, [4096, 4059]), (3, 192, [192, 0, 155])):
        (q, k, v, dout), lens = inputs(b, n, lens_list)
        for rate in (0.1, 0.0):
            out, lse = ta.flash_forward(q, k, v, lens, rate, 77)
            dd = ta.row_dot(dout, out)
            dq = ta.flash_dq(q, k, v, lens, lse, dd, dout, rate, 77)
            dk, dv = ta.flash_dkv(q, k, v, lens, lse, dd, dout, rate, 77)
            torch.cuda.synchronize()
            cs.log(f"digests b={b} n={n} lens {lens_list} dropout {rate}: "
                   + ", ".join(f"{name} {digest(t)}" for name, t in
                               (("O", out), ("LSE", lse), ("dq", dq), ("dk", dk), ("dv", dv))))

    for n in (4096, 1024):
        (q, k, v, dout), lens = inputs(2, n, [n, n - 37])
        for rate in (0.0, 0.1):
            out, lse = ta.flash_forward(q, k, v, lens, rate, 77)
            dd = ta.row_dot(dout, out)
            ms = {"fwd": cs.cuda_median_ms(lambda: ta.flash_forward(q, k, v, lens, rate, 77)),
                  "dq": cs.cuda_median_ms(
                      lambda: ta.flash_dq(q, k, v, lens, lse, dd, dout, rate, 77)),
                  "dkv": cs.cuda_median_ms(
                      lambda: ta.flash_dkv(q, k, v, lens, lse, dd, dout, rate, 77))}
            cs.log(f"times b=2 n={n} lens [{n}, {n - 37}] dropout {rate}: forward "
                   f"{ms['fwd']:.4f} ms, dq {ms['dq']:.4f} ms, dk/dv {ms['dkv']:.4f} ms, "
                   f"dq + dk/dv {ms['dq'] + ms['dkv']:.4f} ms")
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    for n in (1088, 4096):
        (q, k, v, _), lens = inputs(2, n, [n, n - 37])
        rope = rotary_freqs(n, 64, device=dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        key_mask = (torch.arange(n, device=dev)[None] < lens[:, None])[:, None, None, :]
        ms = {
            "4a keep = 1": lambda: ta.flash_forward(q, k, v, lens, 0.0, 77),
            "4a dropout 0.1": lambda: ta.flash_forward(q, k, v, lens, 0.1, 77),
            "1 rope=None": lambda: sa.serving_attention(q, k, v, lens, None),
            "1 rotary": lambda: sa.serving_attention(q, k, v, lens, rope),
            "library, no mask": lambda: F.scaled_dot_product_attention(qt, kt, vt),
            "library, key mask": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                       attn_mask=key_mask),
        }
        cs.log(f"forward times b=2 n={n} lens [{n}, {n - 37}]: "
               + ", ".join(f"{name} {cs.cuda_median_ms(fn):.4f} ms" for name, fn in ms.items()))
    if "--step" in argv[1:]:
        cs.phase_train(dev)
    if "--serve" in argv[1:]:
        serve(cs, dev)
    return 0


FFMA_OPS_S, TF32X3_OPS_S = 67e12, 495e12 / 3  # the H100's fp32 FFMA and 3xTF32 peaks


def other_kernels(tree: Path):
    """The kernels (`ops/_cuda.py` ``Kernels``: the library and nvcc's log) of
    another tree, built from its own `csrc/` into its own `_build/` and
    loaded beside this process's (ctypes keeps each library's symbols
    apart)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "other_tree_cuda", tree / "eraxvif5tts_tpu_torch" / "ops" / "_cuda.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclass looks itself up there
    spec.loader.exec_module(module)
    return module.kernels()


def fp32_fwd(lib, q, k, v, lens, rate: float, seed: int) -> list:
    """[O, LSE] from ``lib``'s fp32 forward entry point, uncounted."""
    import torch

    from eraxvif5tts_tpu_torch.ops import _cuda

    b, n, h, d = q.shape
    out, lse = torch.empty_like(q), torch.empty((b, h, n), device=q.device)
    entry = "erax_train_attention_fp32_fwd"
    fn = getattr(lib, entry)
    dims = _dims_for(fn, 6, b, n, h, d)
    _cuda.check(fn(
        *[t.data_ptr() for t in (q, k, v, lens, out, lse)], *dims, 1.0 / d ** 0.5,
        *_dropout_for(fn, 7 + len(dims), rate, seed), _cuda.stream_ptr(q.device)), entry)
    return [out, lse]


def _dims_for(fn, first: int, b: int, n: int, h: int, d: int) -> tuple:
    """The shape arguments of an entry point whose b is argument ``first``:
    (b, n, h, d), or (b, n, h) for a tree from before head dim 128 (its
    scale, a float, follows h)."""
    import ctypes

    return (b, n, h, d) if fn.argtypes[first + 3] is ctypes.c_int else (b, n, h)


def _dropout_for(fn, before: int, rate: float, seed: int) -> tuple:
    """The dropout arguments an entry point with ``before`` arguments ahead of
    them takes: a tree older than the batch / head offsets takes the first
    four."""
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    return ta._dropout_args(rate, seed)[:len(fn.argtypes) - before - 1]


def fp32_serve(lib, q, k, v, lens, tables):
    """Kernel 1 fp32 from ``lib``'s entry point, uncounted; ``tables`` the
    (cos, sin) of `rope_tables`, or None without rotary."""
    import torch

    from eraxvif5tts_tpu_torch.ops import _cuda

    b, n, h, d = q.shape
    out = torch.empty_like(q)
    cos, sin = tables if tables is not None else (None, None)
    entry = "erax_serving_attention_fp32"
    fn = getattr(lib, entry)
    # b, n, h, then d (this tree) before the rotary flag and the scale
    dims = (b, n, h, d) if len(fn.argtypes) == 14 else (b, n, h)
    _cuda.check(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
        out.data_ptr(), *dims, int(tables is not None), 1.0 / d ** 0.5,
        _cuda.stream_ptr(q.device)), entry)
    return out


FP32_FORWARDS = ("train_fp32_fwd_kernel", "serving_attention_fp32_kernel")
# the fp32 dq and dk/dv instantiations: d = 64 and 128, and d = 256's of this
# tree and of the trees before it
FP32_BACKWARDS = ("train_fp32_dq_kernel", "train_fp32_dkv_kernel", "train_fp32_dq_pairs_kernel",
                  "train_fp32_dkv_pairs_kernel", "train_fp32_dq_wide_kernel",
                  "train_fp32_dkv_wide_kernel")


def forward_registers(kernels, names: tuple[str, ...] = FP32_FORWARDS) -> list[str]:
    """nvcc's register lines of the named kernels' instantiations in a build
    log (the fp32 forwards by default): the kernel, its template argument and
    what ptxas reported."""
    lines = [line.strip() for line in kernels.log.splitlines()]
    found = []
    for i, line in enumerate(lines):
        for name in names:
            if "Compiling entry" in line and name in line:
                # the template arguments: Li128E (int), Lb1E (bool), in order
                tail = line.split(name)[1].split("EEv")[0] + "E"
                arg = ", ".join(value for _, value in re.findall(r"L([ib])(\d+)E", tail))
                after = []
                for x in lines[i + 1:i + 5]:
                    if "Compiling entry" in x:
                        break
                    after.append(x)
                report = " ".join(x for x in after if "registers" in x or "spill" in x)
                found.append(f"{name}<{arg}>: {report}")
    return found


def fp32_dq(lib, q, k, v, lens, lse, dd, dout, rate: float, seed: int):
    """dq from ``lib``'s fp32 dq entry point (the C interface
    `ops/train_attention.py` launches), uncounted."""
    return _fp32_launch(lib, "erax_train_attention_fp32_dq", 1, q, k, v, lens, lse, dd, dout,
                        rate, seed)[0]


def fp32_dkv(lib, q, k, v, lens, lse, dd, dout, rate: float, seed: int) -> list:
    """[dk, dv] from ``lib``'s fp32 dk/dv entry point, uncounted."""
    return _fp32_launch(lib, "erax_train_attention_fp32_dkv", 2, q, k, v, lens, lse, dd, dout,
                        rate, seed)


def _fp32_launch(lib, entry: str, outputs: int, q, k, v, lens, lse, dd, dout, rate, seed):
    import torch

    from eraxvif5tts_tpu_torch.ops import _cuda

    b, n, h, d = q.shape
    out = [torch.empty_like(q) for _ in range(outputs)]
    fn = getattr(lib, entry)
    dims = _dims_for(fn, 7 + outputs, b, n, h, d)
    _cuda.check(fn(
        *[t.data_ptr() for t in (q, k, v, dout, lse, dd, lens, *out)], *dims, 1.0 / d ** 0.5,
        *_dropout_for(fn, 8 + outputs + len(dims), rate, seed), _cuda.stream_ptr(q.device)),
        entry)
    return out


def fp32_builds(cs, other: str | None) -> dict:
    """TREE's kernels and, with ``other``, OTHER's, each build's fp32 forward
    register report logged; torch's TF32 flags off."""
    import torch

    from eraxvif5tts_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    builds = {"tree": _cuda.kernels()}
    if other is not None:
        builds["other"] = other_kernels(Path(other).resolve())
    for who, built in builds.items():
        for line in forward_registers(built):
            cs.log(f"fp32 forward registers, {who.upper()}'s build: {line}")
        for line in forward_registers(built, FP32_BACKWARDS):
            cs.log(f"fp32 backward registers, {who.upper()}'s build: {line}")
    return {who: built.lib for who, built in builds.items()}


def fp32_digests(cs, dev, g, libs: dict, d: int = 64) -> None:
    """Digests of the fp32 kernels' O, LSE, dq, dk, dv at head dim ``d`` (h =
    1024 / d) on seeded inputs, their errors against the plain version and,
    with OTHER's build in ``libs``, the largest differences from OTHER's."""
    import torch

    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    names = ("O", "LSE", "dq", "dk", "dv")

    def inputs(b, n, lens):
        return ([torch.randn((b, n, 1024 // d, d), generator=g, device=dev) for _ in range(4)],
                torch.tensor(lens, dtype=torch.int32, device=dev))

    def grads(lib, q, k, v, dout, lens, rate):
        out, lse = fp32_fwd(lib, q, k, v, lens, rate, 77)
        dd = ta.row_dot(dout, out)
        args = (q, k, v, lens, lse, dd, dout, rate, 77)
        return [out, lse, fp32_dq(lib, *args), *fp32_dkv(lib, *args)]

    for b, n, lens_list in ((2, 4096, [4096, 4059]), (3, 192, [192, 0, 155])):
        (q, k, v, dout), lens = inputs(b, n, lens_list)
        for rate in (0.1, 0.0):
            got = grads(libs["tree"], q, k, v, dout, lens, rate)
            args = [t.clone().requires_grad_() for t in (q, k, v)]
            out = ta.train_attention_reference(*args, lens, rate, 77)
            want = [out.detach(), None, *torch.autograd.grad(out, args, dout)]
            err = {"O": float(((got[0] - want[0]).abs() / (1 + want[0].abs())).max())}
            for name, x, w in zip(names[2:], got[2:], want[2:]):
                err[name] = float((x - w).abs().max() / w.abs().max())
            line = (f"fp32 digests d={d} b={b} n={n} lens {lens_list} dropout {rate}: "
                    + ", ".join(f"{name} {digest(t)}" for name, t in zip(names, got))
                    + "; against plain " + ", ".join(f"{k_} {e:.3g}" for k_, e in err.items()))
            if "other" in libs:
                theirs = grads(libs["other"], q, k, v, dout, lens, rate)
                line += ("; against OTHER's: O max |diff| "
                         f"{float((got[0] - theirs[0]).abs().max()):.3g}, LSE max |diff| "
                         f"{float((got[1] - theirs[1]).abs().max()):.3g}, gradients "
                         + ", ".join(f"{name} {float((x - y).abs().max() / y.abs().max()):.3g}"
                                     for name, x, y in zip(names[2:], got[2:], theirs[2:]))
                         + " of their scale")
            cs.log(line)
            del got, want, out, args


def fp32(cs, dev, g, other: str | None) -> None:
    """The fp32 kernels' digests, errors and times (`--fp32`), and with
    ``other`` that tree's forward, dq, dk/dv and kernel 1 in turns with
    this one's."""
    import torch
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    libs = fp32_builds(cs, other)
    fp32_digests(cs, dev, g, libs)
    order = ("other", "tree", "tree", "other") if "other" in libs else ("tree",)

    def inputs(b, n, lens):
        return ([torch.randn((b, n, 16, 64), generator=g, device=dev) for _ in range(4)],
                torch.tensor(lens, dtype=torch.int32, device=dev))

    for n in (4096, 1024):
        (q, k, v, dout), lens = inputs(2, n, [n, n - 37])
        elems, rows, keys = 2 * n * 16 * 64, 2 * 16 * n, 2 * n - 37
        work = 2.0 * 16 * 64 * n * keys
        least = {"fwd": (2 * work / TF32X3_OPS_S, 2 * work / FFMA_OPS_S),
                 "dq": (3 * work / TF32X3_OPS_S, 3 * work / FFMA_OPS_S),
                 "dkv": (4 * work / TF32X3_OPS_S, 4 * work / FFMA_OPS_S)}
        for rate in (0.0, 0.1):
            out, lse = ta.flash_forward_fp32(q, k, v, lens, rate, 77)
            dd = ta.row_dot(dout, out)
            ms = {who: {"fwd": [], "dq": [], "dkv": []} for who in libs}
            args = (q, k, v, lens, lse, dd, dout, rate, 77)
            for who in order:
                lib = libs[who]
                ms[who]["fwd"].append(cs.cuda_median_ms(
                    lambda: fp32_fwd(lib, q, k, v, lens, rate, 77)))
                ms[who]["dq"].append(cs.cuda_median_ms(lambda: fp32_dq(lib, *args)))
                ms[who]["dkv"].append(cs.cuda_median_ms(lambda: fp32_dkv(lib, *args)))
            mine = ms["tree"]
            line = (f"fp32 times b=2 n={n} lens [{n}, {n - 37}] dropout {rate}: forward "
                    + " / ".join(f"{t:.4f}" for t in mine["fwd"]) + " ms (share of its "
                    f"3xTF32 bound {least['fwd'][0] * 1e3:.5f} ms "
                    f"{least['fwd'][0] * 1e3 / min(mine['fwd']):.1%}, of its FFMA bound "
                    f"{least['fwd'][1] * 1e3:.5f} ms {least['fwd'][1] * 1e3 / min(mine['fwd']):.1%}"
                    "); dq " + " / ".join(f"{t:.4f}" for t in mine["dq"])
                    + " ms, dk/dv " + " / ".join(f"{t:.4f}" for t in mine["dkv"]) + " ms; bounds "
                    f"3xTF32 dq {least['dq'][0] * 1e3:.5f} / dk/dv {least['dkv'][0] * 1e3:.5f} ms, "
                    f"FFMA {least['dq'][1] * 1e3:.5f} / {least['dkv'][1] * 1e3:.5f} ms (share "
                    f"of 3xTF32 {least['dq'][0] * 1e3 / min(mine['dq']):.1%} / "
                    f"{least['dkv'][0] * 1e3 / min(mine['dkv']):.1%}, of FFMA "
                    f"{least['dq'][1] * 1e3 / min(mine['dq']):.1%} / "
                    f"{least['dkv'][1] * 1e3 / min(mine['dkv']):.1%})")
            if "other" in ms:
                theirs = ms["other"]
                line += ("; OTHER's forward " + " / ".join(f"{t:.4f}" for t in theirs["fwd"])
                         + " ms, dq " + " / ".join(f"{t:.4f}" for t in theirs["dq"])
                         + " ms, dk/dv " + " / ".join(f"{t:.4f}" for t in theirs["dkv"])
                         + f" ms (OTHER, TREE, TREE, OTHER); forward TREE "
                         f"{min(mine['fwd']):.4f} against OTHER {min(theirs['fwd']):.4f} ms "
                         f"({min(theirs['fwd']) / min(mine['fwd']):.2f}x); dq + dk/dv TREE "
                         f"{min(mine['dq']) + min(mine['dkv']):.4f} ms against OTHER "
                         f"{min(theirs['dq']) + min(theirs['dkv']):.4f} ms")
            cs.log(line)
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = ta.train_attention_reference(*args, lens, 0.1, 77)
        plain = cs.cuda_median_ms(lambda: torch.autograd.grad(ref, args, dout,
                                                              retain_graph=True),
                                  iters=5, warmup=1)
        del ref
        lib_args = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_args)
        sdpa = cs.cuda_median_ms(lambda: torch.autograd.grad(lib_out, lib_args,
                                                             dout.transpose(1, 2),
                                                             retain_graph=True))
        sdpa_fwd = cs.cuda_median_ms(lambda: F.scaled_dot_product_attention(*lib_args))
        cs.log(f"fp32 yardsticks b=2 n={n}: plain backward (all three gradients, dropout 0.1) "
               f"{plain:.4f} ms; fp32 scaled_dot_product_attention (TF32 off, no mask) forward "
               f"{sdpa_fwd:.4f} ms, backward {sdpa:.4f} ms")
        del lib_out, lib_args, args
    serving_fp32(cs, dev, g, libs, order)


def wide_fp32(cs, dev, g, other: str | None, d: int, backward_only: bool = False,
              forward_only: bool = False) -> None:
    """The fp32 kernels at head dim ``d`` (`--fp32 --head-dim`): the digests
    at every head dim first, then dq and dk/dv (`wide_backward`, unless
    ``forward_only``: `--forward`) and, unless ``backward_only``, the
    forward: each tree's errors against the plain version and the trees'
    largest differences, times in turns beside the bound and fp32 SDPA, and
    the wave tail at n = 1088 against 1024. At d = 64 (`--forward` alone
    takes it) the forward's cases with and without rotary."""
    import torch
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    if d not in ((64, 128, 256) if forward_only else (128, 256)):
        raise ValueError(f"--head-dim takes 128 or 256 (64 with --forward), got {d}")
    libs = fp32_builds(cs, other)
    for dim in (64, 128, 256):
        fp32_digests(cs, dev, g, libs, dim)
    order = ("other", "tree", "tree", "other") if "other" in libs else ("tree",)
    if not forward_only:
        wide_backward(cs, dev, g, libs, order, d)
    if backward_only:
        return
    h = 1024 // d
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    serve_ms = {}
    cases = [("serve", n, lens_list, roped) for n, lens_list in ((1088, [1051, 0]),
                                                                  (1024, [1024, 987]),
                                                                  (576, [576, 576]))
             for roped in ((False,) if d == 256 else (False, True))]
    cases += [("train", 4096, [4096, 4059], rate) for rate in (0.0, 0.1)]
    for role, n, lens_list, arg in cases:
        q, k, v = (torch.randn((2, n, h, d), generator=g, device=dev) for _ in range(3))
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if role == "serve":
            tables = sa.rope_tables(rotary_freqs(n, d, device=dev)) if arg else None
            rope = rotary_freqs(n, d, device=dev) if arg else None
            nbytes, ops = cs.attention_work(2, n, h, d, lens_list, arg, 4)

            def run(lib):
                return [fp32_serve(lib, q, k, v, lens, tables)]

            want = [sa.serving_attention_reference(q, k, v, lens, rope)]
            key_mask = (torch.arange(n, device=dev)[None] < lens[:, None])[:, None, None, :]
            if arg:  # SDPA on q and k rotated outside it, as the plain version rotates them
                qt, kt = (sa._rotate(t, rope).transpose(1, 2) for t in (q, k))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_mask)

            name = f"kernel 1 fp32 d={d} h={h} n={n} lens {lens_list} " + (
                "rotary" if arg else "rope=None")
        else:
            keys = sum(min(length, n) for length in lens_list)
            ops = 4.0 * h * d * n * keys

            def run(lib):
                return fp32_fwd(lib, q, k, v, lens, arg, 77)

            out = ta.train_attention_reference(q, k, v, lens, arg, 77)
            want = [out, cs.plain_lse(q, k, lens)]

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt)

            name = f"kernel 4a fp32 d={d} h={h} n={n} lens {lens_list} dropout {arg}"
        mine = run(libs["tree"])
        err = [float(((mine[0] - want[0]).abs() / (1 + want[0].abs())).max())]
        if len(mine) > 1:
            err.append(float((mine[1] - want[1]).abs().max()))
        line = f"{name}: TREE against plain " + ", ".join(
            f"{k_} {e:.3g}" for k_, e in zip(("O", "LSE"), err))
        if "other" in libs:
            theirs = run(libs["other"])
            line += "; TREE against OTHER " + ", ".join(
                f"{k_} max |diff| {float((x - y).abs().max()):.3g}"
                for k_, x, y in zip(("O", "LSE"), mine, theirs))
        ms = {who: [] for who in libs}
        lib_ms = []
        for who in order:
            lib = libs[who]
            ms[who].append(cs.cuda_median_ms(lambda: run(lib)))
            lib_ms.append(cs.cuda_median_ms(sdpa))
        least = ops / TF32X3_OPS_S * 1e3
        best = min(ms["tree"])
        line += (f"; TREE " + " / ".join(f"{t:.4f}" for t in ms["tree"]) + f" ms (3xTF32 bound "
                 f"{least:.5f} ms, {least / best:.1%}); fp32 SDPA "
                 + " / ".join(f"{t:.4f}" for t in lib_ms)
                 + f" ms (TREE {best / min(lib_ms):.2f}x its time)")
        if "other" in ms:
            line += (f"; OTHER " + " / ".join(f"{t:.4f}" for t in ms["other"])
                     + f" ms (OTHER, TREE, TREE, OTHER: TREE {best / min(ms['other']):.3f}x "
                     "OTHER's time)")
        cs.log(line)
        if role == "serve" and not arg:
            serve_ms[n] = {who: min(t) for who, t in ms.items()}
        del q, k, v, qt, kt, vt, mine, want
    blocks = {n: 2 * h * n // 64 for n in serve_ms}
    for who in serve_ms[1088]:
        ratio = serve_ms[1088][who] / serve_ms[1024][who]
        work = (1051 * 1088 + 1088 * 1088) / (1024 * 1024 + 987 * 1024)
        cs.log(f"fp32 d={d} wave tail, {who.upper()}: n = 1088 {blocks[1088]} blocks "
               f"({blocks[1088] / sms:.2f} waves at one an SM) {serve_ms[1088][who]:.4f} ms, "
               f"n = 1024 {blocks[1024]} blocks ({blocks[1024] / sms:.2f} waves) "
               f"{serve_ms[1024][who]:.4f} ms: {ratio:.3f}x the time for {work:.3f}x the work")


def train_steps(cs, dev, d: int, reps: int, dname: str = "fp32") -> None:
    """TREE's fp32 (or bf16) CFM step of its `[d128]` (d = 128) or `[d256]`
    (d = 256) DiT at dropout 0.1 (`--train-step`), ``reps`` times."""
    import tempfile

    import torch

    heads = {128: cs.D128_HEADS, 256: cs.D256_HEADS}[d]
    with tempfile.TemporaryDirectory() as tmp:
        cfg, _ = cs.head_dim_config(Path(tmp), heads, d, f"[d{d}]")
    if dname == "fp32":
        variant = (None, "fp32", 0.1, {"loss": cs.D128_FP32_LOSS_TOL,
                                       "gradient L2": cs.FP32_STEP_GRAD_TOL,
                                       "q/k/v gradient L2": cs.FP32_STEP_GRAD_TOL}, "keys")
    else:
        variant = (torch.bfloat16, "bf16", 0.1, {"loss": cs.D128_LOSS_TOL,
                                                 "gradient L2": cs.D128_GRAD_TOL,
                                                 "q/k/v gradient L2": cs.QKV_GRAD_TOL}, "keys")
    for rep in range(reps):
        cs.train_at(dev, cfg.arch, f"[d{d} step {rep}]", (variant,))


def loss_seeds(cs, dev, d: int, seeds: int) -> None:
    """The smoke's bf16 CFM-loss check at head dim ``d``, dropout 0.1
    (`--loss-seeds`): `chip_smoke.train_at`'s DiT and loss batch, the batch
    seed stepped from the smoke's own, each seed's readings logged by
    `hold_loss_against_plain` with no limit held; then the largest loss
    error and the smallest control."""
    import dataclasses
    import re
    import tempfile

    import torch

    from eraxvif5tts_tpu_torch.models.cfm import CFM
    from eraxvif5tts_tpu_torch.models.dit import DiT

    heads = {128: cs.D128_HEADS, 256: cs.D256_HEADS}[d]
    with tempfile.TemporaryDirectory() as tmp:
        cfg, _ = cs.head_dim_config(Path(tmp), heads, d, f"[d{d}]")
    arch = dataclasses.replace(cfg.arch, dropout=0.1, checkpoint_activations=True,
                               remat_policy="full")
    dit = DiT(arch, text_num_embeds=len(cs.VOCAB_CHARS), mel_dim=100,
              compute_dtype=torch.bfloat16).to(dev)
    cs.randomize((dit,), cs.SEED)
    cfm = CFM(dit.train())
    lines, log = [], cs.log
    cs.log = lambda *a: (lines.append(" ".join(map(str, a))), log(*a))
    try:
        for i in range(seeds):
            mel, text, lens, draws = cs.loss_batch(dev, cs.SEED + 180 + i, arch.depth)
            cs.hold_loss_against_plain(
                f"[d{d} loss seed {cs.SEED + 180 + i}] bf16 CFM.loss b=2 n={mel.shape[1]} "
                "dropout 0.1", dit, lambda draws: cfm.loss(mel, text, lens, draws)[0], draws, {})
    finally:
        cs.log = log
    got = [re.search(r"loss ([0-9.e+-]+) \(logged\) / ([0-9.e+-]+)", line) for line in lines]
    err, ctl = [float(m[1]) for m in got if m], [float(m[2]) for m in got if m]
    cs.log(f"[d{d}] bf16 CFM.loss at dropout 0.1 over {len(err)} seeds: errors "
           + ", ".join(f"{e:.3g}" for e in err) + f" (largest {max(err):.3g}); wrong-keys "
           "controls " + ", ".join(f"{c:.3g}" for c in ctl) + f" (smallest {min(ctl):.3g})")


def span_ms(fn, calls: int = 100, spans: int = 7) -> float:
    """The median over ``spans`` CUDA-event spans of ``calls`` calls of ``fn``
    back to back, over ``calls``: the card's time a call once the host runs
    ahead of it (one call timed alone also counts the launch's own latency)."""
    import statistics

    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(spans):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bf16_launch(lib, entry: str, outputs: int, q, k, v, lens, *rest) -> list:
    """``outputs`` [b, n, h, d] bf16 tensors from a bf16 training entry point of
    ``lib`` (`erax_train_attention_fwd`: O and the LSE; `_dq`; `_dkv`),
    uncounted; ``rest`` the backward's (lse, dd, dout) then (rate, seed)."""
    import torch

    from eraxvif5tts_tpu_torch.ops import _cuda
    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    b, n, h, d = q.shape
    fn = getattr(lib, entry)
    *tensors, rate, seed = rest
    if entry == "erax_train_attention_fwd":
        out = [torch.empty_like(q), torch.empty((b, h, n), device=q.device)]
        ptrs = [t.data_ptr() for t in (q, k, v, lens, *out)]
    else:
        lse, dd, dout = tensors
        out = [torch.empty_like(q) for _ in range(outputs)]
        ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, dd, lens, *out)]
    _cuda.check(fn(*ptrs, b, n, h, d, 1.0 / d ** 0.5, *ta._dropout_args(rate, seed),
                   _cuda.stream_ptr(q.device)), entry)
    return out


def bf16_serve(lib, q, k, v, lens, tables):
    """Kernel 1 bf16 from ``lib``'s entry point, uncounted; ``tables`` the
    (cos, sin) of `rope_tables`, or None without rotary."""
    import torch

    from eraxvif5tts_tpu_torch.ops import _cuda

    b, n, h, d = q.shape
    out = torch.empty_like(q)
    cos, sin = tables if tables is not None else (None, None)
    _cuda.check(lib.erax_serving_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
        out.data_ptr(), b, n, h, d, int(tables is not None), 1.0 / d ** 0.5,
        _cuda.stream_ptr(q.device)), "erax_serving_attention")
    return out


def wide_bf16(cs, dev, g, other: str | None, d: int, digests: bool = True) -> None:
    """The bf16 forward core at head dim ``d`` (`--head-dim` without
    `--fp32`): both builds' ptxas reports, the digests at every head dim
    (unless ``digests`` is false: `--no-digests`), then kernel 4a and kernel
    1 at d in turns beside SDPA's flash backend."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from eraxvif5tts_tpu_torch.ops import _cuda
    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    if d not in (64, 128, 256):
        raise ValueError(f"--head-dim takes 64, 128 or 256, got {d}")
    builds = {"tree": _cuda.kernels()}
    if other is not None:
        builds["other"] = other_kernels(Path(other).resolve())
    for who, built in builds.items():
        for dim in (64, 128, 256):
            for line in cs.forward_build_notes(built.log, dim):
                cs.log(f"bf16 forward d={dim}, {who.upper()}'s build: {line}")
    libs = {who: built.lib for who, built in builds.items()}
    names = ("O", "LSE", "dq", "dk", "dv")

    def grads(lib, q, k, v, dout, lens, rate):
        out, lse = bf16_launch(lib, "erax_train_attention_fwd", 2, q, k, v, lens, rate, 77)
        dd = ta.row_dot(dout, out)
        rest = (lse, dd, dout, rate, 77)
        return [out, lse, *bf16_launch(lib, "erax_train_attention_dq", 1, q, k, v, lens, *rest),
                *bf16_launch(lib, "erax_train_attention_dkv", 2, q, k, v, lens, *rest)]

    for dim in (64, 128, 256) if digests else ():
        for b, n, lens_list in ((2, 4096, [4096, 4059]), (3, 192, [192, 0, 155])):
            q, k, v, dout = (torch.randn((b, n, 1024 // dim, dim), generator=g,
                                         device=dev).bfloat16() for _ in range(4))
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            for rate in (0.1, 0.0):
                got = grads(libs["tree"], q, k, v, dout, lens, rate)
                args = [t.clone().requires_grad_() for t in (q, k, v)]
                ref = ta.train_attention_reference(*args, lens, rate, 77)
                want = [ref.detach(), cs.plain_lse(q, k, lens),
                        *torch.autograd.grad(ref, args, dout)]
                err = {name: float((x.float() - w.float()).norm() / w.float().norm())
                       for name, x, w in zip(names, got, want)}
                line = (f"bf16 digests d={dim} b={b} n={n} lens {lens_list} dropout {rate}: "
                        + ", ".join(f"{name} {digest(t)}" for name, t in zip(names, got))
                        + "; relative L2 against plain "
                        + ", ".join(f"{k_} {e:.3g}" for k_, e in err.items()))
                if "other" in libs:
                    theirs = grads(libs["other"], q, k, v, dout, lens, rate)
                    line += "; against OTHER's: max |diff| " + ", ".join(
                        f"{name} {float((x.float() - y.float()).abs().max()):.3g}"
                        for name, x, y in zip(names, got, theirs))
                cs.log(line)
                del got, want, ref, args
            del q, k, v, dout
    order = ("other", "tree", "tree", "other") if "other" in libs else ("tree",)
    h = 1024 // d
    cases = [("train", n, [n, n - 37], rate) for n in (4096, 6144) for rate in (0.0, 0.1)]
    cases += [("serve", n, lens_list, roped) for n, lens_list in ((1088, [1051, 0]),
                                                                  (4096, [4096, 4059]))
              for roped in ((False,) if d == 256 else (True, False))]
    for role, n, lens_list, arg in cases:
        q, k, v = (torch.randn((2, n, h, d), generator=g, device=dev).bfloat16()
                   for _ in range(3))
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nbytes, ops = cs.attention_work(2, n, h, d, lens_list, role == "serve" and arg, 2)
        if role == "serve":
            tables = sa.rope_tables(rotary_freqs(n, d, device=dev)) if arg else None
            rope = rotary_freqs(n, d, device=dev) if arg else None

            def run(lib):
                return [bf16_serve(lib, q, k, v, lens, tables)]

            want = [sa.serving_attention_reference(q, k, v, lens, rope)]
            if arg:  # SDPA on q and k rotated outside it
                qt, kt = (sa._rotate(t, rope).transpose(1, 2) for t in (q, k))
            name = f"kernel 1 bf16 d={d} h={h} n={n} lens {lens_list} " + (
                "rotary" if arg else "rope=None")
        else:
            def run(lib):
                return bf16_launch(lib, "erax_train_attention_fwd", 2, q, k, v, lens, arg, 77)

            want = [ta.train_attention_reference(q, k, v, lens, arg, 77),
                    cs.plain_lse(q, k, lens)]
            name = f"kernel 4a bf16 d={d} h={h} n={n} lens {lens_list} dropout {arg}"

        # as `chip_smoke.time_train_attention` gives it: heads second, views
        # that take a gradient, the dispatcher's backend; and its flash backend
        lib_args = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        backend = SDPBackend(torch._fused_sdp_choice(*lib_args)).name

        def sdpa():
            return F.scaled_dot_product_attention(*lib_args)

        def sdpa_flash():
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return F.scaled_dot_product_attention(*lib_args)

        mine = run(libs["tree"])
        err = [float(((mine[0].float() - want[0].float()).abs()
                      / (1 + want[0].float().abs())).max())]
        if len(mine) > 1:
            err.append(float((mine[1] - want[1]).abs().max()))
        line = f"{name}: TREE against plain " + ", ".join(
            f"{k_} {e:.3g}" for k_, e in zip(("O", "LSE"), err))
        if "other" in libs:
            theirs = run(libs["other"])
            line += "; TREE against OTHER " + ", ".join(
                f"{k_} max |diff| {float((x.float() - y.float()).abs().max()):.3g}"
                for k_, x, y in zip(("O", "LSE"), mine, theirs))
        ms = {who: [] for who in libs}
        lib_ms, flash_ms = [], []
        for who in order:
            lib = libs[who]
            ms[who].append(span_ms(lambda: run(lib)))
            lib_ms.append(span_ms(sdpa))
            flash_ms.append(span_ms(sdpa_flash))
        least = cs.bound(nbytes, ops)["bound_ms"]
        best = min(ms["tree"])
        line += (f"; TREE " + " / ".join(f"{t:.4f}" for t in ms["tree"]) + f" ms (bound "
                 f"{least:.5f} ms, {least / best:.1%}); SDPA ({backend}) "
                 + " / ".join(f"{t:.4f}" for t in lib_ms)
                 + f" ms (TREE {best / min(lib_ms):.3f}x its time); SDPA's flash backend "
                 + " / ".join(f"{t:.4f}" for t in flash_ms)
                 + f" ms (TREE {best / min(flash_ms):.3f}x)")
        if "other" in ms:
            line += (f"; OTHER " + " / ".join(f"{t:.4f}" for t in ms["other"])
                     + f" ms (OTHER, TREE, TREE, OTHER: TREE {best / min(ms['other']):.3f}x "
                     "OTHER's time)")
        cs.log(line)
        del q, k, v, qt, kt, vt, mine, want, lib_args


def wide_backward(cs, dev, g, libs: dict, order: tuple, d: int) -> None:
    """dq and dk/dv at head dim ``d`` (`--fp32 --head-dim`): each tree's errors
    against the plain version's autograd and the trees' largest differences,
    times in turns beside the 3xTF32 bounds, the plain backward and fp32
    SDPA's backward in the same turns."""
    import torch
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import train_attention as ta

    h = 1024 // d
    names = ("dq", "dk", "dv")
    for n in (4096, 6144):
        lens_list = [n, n - 37]
        q, k, v, dout = (torch.randn((2, n, h, d), generator=g, device=dev) for _ in range(4))
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        work = 2.0 * h * d * n * sum(lens_list)  # one product over the valid keys
        least = {"dq": 3 * work / TF32X3_OPS_S * 1e3, "dkv": 4 * work / TF32X3_OPS_S * 1e3}
        for rate in (0.0, 0.1):
            out, lse = fp32_fwd(libs["tree"], q, k, v, lens, rate, 77)
            dd = ta.row_dot(dout, out)
            args = (q, k, v, lens, lse, dd, dout, rate, 77)
            got = {who: [fp32_dq(lib, *args), *fp32_dkv(lib, *args)] for who, lib in libs.items()}
            ref_args = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = ta.train_attention_reference(*ref_args, lens, rate, 77)
            want = torch.autograd.grad(ref, ref_args, dout, retain_graph=True)
            line = f"fp32 backward d={d} h={h} n={n} lens {lens_list} dropout {rate}:"
            for who, grads in got.items():
                line += f" {who.upper()} against plain " + ", ".join(
                    f"{name} {float((x - w).abs().max() / w.abs().max()):.3g}"
                    for name, x, w in zip(names, grads, want)) + ";"
            if "other" in got:
                line += " TREE against OTHER " + ", ".join(
                    f"{name} max |diff| {float((x - y).abs().max()):.3g}"
                    for name, x, y in zip(names, got["tree"], got["other"])) + ";"
            lib_args = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*lib_args)
            lib_dout = dout.transpose(1, 2)
            ms = {who: {"dq": [], "dkv": []} for who in libs}
            plain_ms, sdpa_ms = [], []
            for who in order:
                lib = libs[who]
                ms[who]["dq"].append(cs.cuda_median_ms(lambda: fp32_dq(lib, *args)))
                ms[who]["dkv"].append(cs.cuda_median_ms(lambda: fp32_dkv(lib, *args)))
                plain_ms.append(cs.cuda_median_ms(
                    lambda: torch.autograd.grad(ref, ref_args, dout, retain_graph=True),
                    iters=5, warmup=1))
                sdpa_ms.append(cs.cuda_median_ms(
                    lambda: torch.autograd.grad(lib_out, lib_args, lib_dout, retain_graph=True)))
            best = {who: {key: min(t) for key, t in kinds.items()} for who, kinds in ms.items()}
            mine = best["tree"]["dq"] + best["tree"]["dkv"]
            line += (" TREE dq " + " / ".join(f"{t:.4f}" for t in ms["tree"]["dq"])
                     + " ms, dk/dv " + " / ".join(f"{t:.4f}" for t in ms["tree"]["dkv"])
                     + f" ms, dq + dk/dv {mine:.4f} ms (3xTF32 bounds dq {least['dq']:.5f} / "
                     f"dk/dv {least['dkv']:.5f} ms, shares "
                     f"{least['dq'] / best['tree']['dq']:.1%} / "
                     f"{least['dkv'] / best['tree']['dkv']:.1%}); plain backward "
                     + " / ".join(f"{t:.4f}" for t in plain_ms) + " ms, fp32 SDPA backward "
                     + " / ".join(f"{t:.4f}" for t in sdpa_ms)
                     + f" ms (TREE's dq + dk/dv {mine / min(plain_ms):.2f}x the plain backward's "
                     f"time, {mine / min(sdpa_ms):.2f}x SDPA's)")
            if "other" in ms:
                theirs = best["other"]["dq"] + best["other"]["dkv"]
                line += ("; OTHER dq " + " / ".join(f"{t:.4f}" for t in ms["other"]["dq"])
                         + " ms, dk/dv " + " / ".join(f"{t:.4f}" for t in ms["other"]["dkv"])
                         + f" ms, dq + dk/dv {theirs:.4f} ms (OTHER, TREE, TREE, OTHER: TREE "
                         f"{mine / theirs:.3f}x OTHER's time; dq "
                         f"{best['tree']['dq'] / best['other']['dq']:.3f}x, dk/dv "
                         f"{best['tree']['dkv'] / best['other']['dkv']:.3f}x)")
            cs.log(line)
            del got, want, ref, ref_args, lib_out, lib_args, out, lse, dd
        del q, k, v, dout


def serving_fp32(cs, dev, g, libs: dict, order: tuple) -> None:
    """Kernel 1 fp32 of each tree in ``libs`` on the same tensors, timed in
    ``order``, beside its bounds and fp32 SDPA with the key mask (`--fp32`)."""
    import torch
    import torch.nn.functional as F

    from eraxvif5tts_tpu_torch.ops import serving_attention as sa
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    for n, lens_list in ((1088, [1051, 0]), (4096, [4096, 4059]), (6144, [6144, 3099])):
        q, k, v = (torch.randn((2, n, 16, 64), generator=g, device=dev) for _ in range(3))
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        nbytes, ops = cs.attention_work(2, n, 16, 64, lens_list, True, 4)
        tf32x3, ffma = ops / TF32X3_OPS_S * 1e3, ops / FFMA_OPS_S * 1e3
        key_mask = (torch.arange(n, device=dev)[None] < lens[:, None])[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = cs.cuda_median_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_mask))
        for roped in (True, False):
            tables = sa.rope_tables(rotary_freqs(n, 64, device=dev)) if roped else None
            ms = {who: [] for who in libs}
            for who in order:
                lib = libs[who]
                ms[who].append(cs.cuda_median_ms(lambda: fp32_serve(lib, q, k, v, lens, tables)))
            mine = min(ms["tree"])
            line = (f"kernel 1 fp32 b=2 h=16 n={n} lens {lens_list} "
                    f"{'rotary' if roped else 'rope=None'}: TREE "
                    + " / ".join(f"{t:.4f}" for t in ms["tree"])
                    + f" ms (share of its 3xTF32 bound {tf32x3:.5f} ms {tf32x3 / mine:.1%}, of "
                    f"its FFMA bound {ffma:.5f} ms {ffma / mine:.1%}); fp32 SDPA with the key "
                    f"mask {sdpa:.4f} ms ({mine / sdpa:.2f}x its time)")
            if "other" in ms:
                diff = (fp32_serve(libs["tree"], q, k, v, lens, tables)
                        - fp32_serve(libs["other"], q, k, v, lens, tables)).abs().max()
                line += (f"; OTHER " + " / ".join(f"{t:.4f}" for t in ms["other"])
                         + f" ms (OTHER, TREE, TREE, OTHER: {min(ms['other']) / mine:.2f}x "
                         f"TREE's time), max |TREE - OTHER| {float(diff):.3g}")
            cs.log(line)
        del q, k, v, qt, kt, vt
    wave_tail(cs, dev, g, libs["tree"])


def wave_tail(cs, dev, g, lib) -> None:
    """What the last, part-filled wave of blocks costs kernel 1 fp32 at the
    DiT's serving shape (`--fp32`): b = 2, n = 1088, lens [1051, 0] at h =
    16 (544 blocks of 64 rows: 2.06 waves at two blocks an SM) against h =
    15 (510 blocks: 1.93 waves), in turns. Without a tail the time would
    grow with the work (16 / 15); with whole waves it grows with their
    count."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ms = {}
    for h in (16, 15, 15, 16):
        q, k, v = (torch.randn((2, 1088, h, 64), generator=g, device=dev) for _ in range(3))
        lens = torch.tensor([1051, 0], dtype=torch.int32, device=dev)
        ms.setdefault(h, []).append(cs.cuda_median_ms(lambda: fp32_serve(lib, q, k, v, lens, None)))
    blocks = {h: 2 * h * 1088 // 64 for h in ms}
    cs.log("kernel 1 fp32 wave tail b=2 n=1088 lens [1051, 0] rope=None: "
           + ", ".join(f"h = {h}: {blocks[h]} blocks ({blocks[h] / (2 * sms):.2f} waves of "
                       f"{2 * sms}) " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                       for h, ts in ms.items())
           + f"; h = 16 takes {min(ms[16]) / min(ms[15]):.3f}x h = 15's time for "
           f"{16 / 15:.3f}x the work")


def tf32_rates(cs, dev) -> None:
    """Build `tools/tf32_rates.cu` into this tree's `_build/` and print its
    rates (`--fp32`)."""
    import ctypes
    import subprocess

    import torch

    from eraxvif5tts_tpu_torch.ops import _cuda

    src = Path(__file__).resolve().parent / "tf32_rates.cu"
    so = _cuda.BUILD_DIR / "tf32_rates.so"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.erax_tf32_rate.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 4 * 256, device=dev)
    iters = 2000
    probes = ((0, "mma.sync m16n8k8 tf32, 1 accumulator a warp", 1),
              (1, "the same, 4 accumulators", 4), (2, "the same, 8 accumulators", 8),
              (3, "cvt.rna.tf32.f32", 0), (4, "rna in two integer operations", 0),
              (5, "fp32 multiply", 0))
    for which, name, chains in probes:
        readings = []
        for per_sm, threads in ((2, 128), (4, 256)):
            blocks = sms * per_sm

            def launch():
                _cuda.check(lib.erax_tf32_rate(which, out.data_ptr(), blocks, threads, iters,
                                               _cuda.stream_ptr(dev)), name)

            ms = cs.cuda_median_ms(launch, iters=5, warmup=2)
            if chains:  # 2 * 16 * 8 * 8 operations an mma, a warp
                rate = blocks * threads // 32 * iters * chains * 2048 / (ms * 1e-3) / 1e12
                readings.append(f"{rate:.1f} TFLOP/s at {per_sm} x {threads}")
            else:
                rate = blocks * threads * iters * 8 / (ms * 1e-3) / 1e12
                readings.append(f"{rate:.2f} T/s at {per_sm} x {threads}")
        cs.log(f"rate of {name}: " + ", ".join(readings))


def serve(cs, dev) -> None:
    """Batch-1 and batched bf16 serving of the tree's wrapper (`--serve`)."""
    import time

    import torch

    wrapper = cs.build_wrapper(dev)
    ref = cs.load_reference(wrapper)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        waves = fn()
        wall = time.perf_counter() - t0
        waves = waves if isinstance(waves, list) else [waves]
        return wall, sum(len(w) for w in waves) / wrapper.target_sample_rate

    def one():
        return wrapper.generate(cs.TEXTS[0], ref=ref, nfe_step=cs.NFE, seed=cs.SEED)

    def batch():
        return wrapper.generate_batch(list(cs.BATCH_TEXTS), ref=ref, nfe_step=cs.NFE,
                                      seed=cs.SEED)

    for name, fn in (("generate, batch 1", one), (f"generate_batch of {len(cs.BATCH_TEXTS)}",
                                                  batch)):
        timed(fn)  # warm-up: first call at this bucket
        runs = [timed(fn) for _ in range(3)]
        cs.log(f"serve bf16 NFE {cs.NFE} {name}: "
               + "; ".join(f"{audio:.2f} s of audio in {wall:.3f} s (RTF {wall / audio:.4f}, "
                           f"{audio / wall:.3f} s of audio per wall s)" for wall, audio in runs))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
