"""Digests and times of the two fused projections (kernel 2 `ln_mod_matmul`,
kernel 3 `matmul_gate_res`) of one tree of the repository, to compare two
trees (a commit and its parent) on one card.

    python3 eraxvif5tts_tpu_torch/tools/probe_gemm.py TREE [--serve]

TREE is the root of a checkout (this one: `.`; another commit: unpack it
with `git archive` into a directory `.gitignore` lists). The package and
`chip_smoke.py` are imported from TREE, the kernels are built there, and
every line printed starts with TREE. Run the trees in turns inside one call
(parent, change, change, parent): a card's clocks and power limit differ
between calls. Printed:

- the card's name and power limit and the build's register report;
- sha256 digests of both kernels' outputs on seeded inputs (kernel 2 in both
  modes at [2, 300, 1024] -> 2048; kernel 3 masked at [2, 300, 2048] -> 1024):
  equal digests mean equal bits;
- for kernel 2 at (B, M) = (2, 768), (2, 1088), (16, 768), K = 1024, with
  N = 2048 in layernorm mode and N = 4096 in RMS mode, and for kernel 3 at
  the same (B, M), K = 2048, N = 1024, masked: the median CUDA-event time of
  single calls (which holds the host's launch gaps) and the mean of 50 calls
  issued back to back (which does not, once the device is the slower side),
  beside the bound (operations over the H100's 989 TFLOP/s bf16 peak) and two
  yardsticks that nothing in the port calls: the unfused bf16 chain a user
  would otherwise run (`F.layer_norm` or the RMS expression, modulate,
  `F.linear`, `F.gelu(approximate="tanh")`; for kernel 3 `F.linear` and one
  `addcmul`), and `F.linear` alone on an activation normalised beforehand:
  the product without the fusion;
- with `--serve`, a bf16 `F5TTSWrapper` at F5TTS_v1_Base width on seeded
  random weights: three `generate`s of the smoke's first text (wall and
  realtime factor at batch 1) and three `generate_batch`es of its eight
  texts (seconds of audio per wall second), at NFE 32 after a warm-up of each.
"""

from __future__ import annotations

import sys
from pathlib import Path

SHAPES = ((2, 768), (2, 1088), (16, 768))
PEAK_BF16 = 989e12


def burst_ms(fn, calls: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``calls`` launches issued back to back."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main(argv: list[str]) -> int:
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(argv[0]).resolve()
    tag = f"[{argv[0]}]"
    sys.path.insert(0, str(tree))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
    from eraxvif5tts_tpu_torch.tools.probe_train_attention import digest, serve

    if Path(cs.__file__).resolve().parent != tree:
        raise RuntimeError(f"chip_smoke was imported from {cs.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        print("probe_gemm: no CUDA device", file=sys.stderr)
        return 2
    log = cs.log
    cs.log = lambda *a: log(tag, *a)
    cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4321)
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev)

    def ln_inputs(b, m, n):
        return ((randn(b, m, 1024) + 0.5).bfloat16(), (0.1 * randn(b, 1024)).bfloat16(),
                (0.1 * randn(b, 1024)).bfloat16(), (randn(n, 1024) / 32).bfloat16(),
                (0.1 * randn(n)).bfloat16())

    def gate_inputs(b, m):
        return (randn(b, m, 2048).bfloat16(), (randn(1024, 2048) / 45).bfloat16(),
                (0.1 * randn(1024)).bfloat16(), randn(b, 1024).bfloat16(),
                randn(b, m, 1024).bfloat16(),
                torch.tensor([m, m - 37] * (b // 2), dtype=torch.int32, device=dev), True)

    args = ln_inputs(2, 300, 2048)
    gate_args = gate_inputs(2, 300)
    outs = (("kernel 2 ln", fm.ln_mod_matmul(*args, norm="ln")),
            ("kernel 2 rms", fm.ln_mod_matmul(*args, norm="rms")),
            ("kernel 2 ln, no activation", fm.ln_mod_matmul(*args, activation=None, norm="ln")),
            ("kernel 3 masked", fm.matmul_gate_res(*gate_args)))
    torch.cuda.synchronize()
    cs.log("digests at [2, 300]: " + ", ".join(f"{name} {digest(t)}" for name, t in outs))

    def times(fns: dict) -> str:
        return ", ".join(f"{name} {cs.cuda_median_ms(fn):.4f} / {burst_ms(fn):.4f} ms"
                         for name, fn in fns.items())

    for norm, n in (("ln", 2048), ("rms", 4096)):
        for b, m in SHAPES:
            x, scale, shift, w, bias = ln_inputs(b, m, n)

            def chain():
                if norm == "ln":
                    h = F.layer_norm(x, (1024,), eps=fm.EPS["ln"])
                else:
                    h = (x.float() * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True)
                                                 + fm.EPS["rms"])).to(x.dtype)
                h = h * (1 + scale[:, None, :]) + shift[:, None, :]
                return F.gelu(F.linear(h, w, bias), approximate="tanh")

            normed = F.layer_norm(x, (1024,))
            cs.log(f"kernel 2 {norm} B={b} M={m} K=1024 N={n}, median of single calls / mean of "
                   f"50 back to back: "
                   + times({"kernel": lambda: fm.ln_mod_matmul(x, scale, shift, w, bias,
                                                               norm=norm),
                            "unfused bf16 chain": chain,
                            "F.linear alone": lambda: F.linear(normed, w)})
                   + f"; bound {2.0 * b * m * 1024 * n / PEAK_BF16 * 1e3:.4f} ms")
    for b, m in SHAPES:
        h, w, bias, gate, res, lens, mask_rows = gate_inputs(b, m)
        gates = gate[:, None, :] * (torch.arange(m, device=dev)[None, :, None]
                                    < lens[:, None, None]).to(gate.dtype)
        rows = int(lens.sum())
        cs.log(f"kernel 3 masked B={b} M={m} K=2048 N=1024, median of single calls / mean of 50 "
               f"back to back: "
               + times({"kernel": lambda: fm.matmul_gate_res(h, w, bias, gate, res, lens,
                                                             mask_rows),
                        "unfused bf16 chain": lambda: torch.addcmul(res, gates,
                                                                    F.linear(h, w, bias)),
                        "F.linear alone": lambda: F.linear(h, w)})
               + f"; bound {2.0 * rows * 2048 * 1024 / PEAK_BF16 * 1e3:.4f} ms")
    if "--serve" in argv[1:]:
        serve(cs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
