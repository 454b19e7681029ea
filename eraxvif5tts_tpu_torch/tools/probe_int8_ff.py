"""Digests and times of kernel 5 (`int8_ff`, the one-kernel int8
feed-forward) of one tree of the repository, and its int8 serving, to compare
two trees (a commit and its parent) on one card.

    python3 eraxvif5tts_tpu_torch/tools/probe_int8_ff.py TREE [--serve]

TREE is the root of a checkout (this one: `.`; another commit: unpack it
with `git archive` into a directory `.gitignore` lists). The package and
`chip_smoke.py` are imported from TREE, the kernels are built there, and
every line printed starts with TREE. Run the trees in turns inside one call
(parent, change, change, parent): a card's clocks and power limit differ
between calls. Printed:

- the card's name and power limit and the build's register report;
- sha256 digests of the kernel's output and of its hidden codes on seeded
  inputs at [2, 300, 1024] through N = 2048 and 4096 (a tree whose kernel
  does not take a width says so): equal digests mean equal bits;
- at (B, M) = (2, 768), (2, 1088), (16, 768), K = K2 = 1024, N = 2048
  (ff_mult 2) and 4096 (ff_mult 4): the median CUDA-event time of single
  calls (which holds the host's launch gaps) and the mean of 50 calls issued
  back to back (which does not, once the device is the slower side), beside
  the bound (operations over the H100's 1,979 TOP/s int8 peak, or bytes over
  3.35 TB/s) and two yardsticks that nothing in the port calls: the
  QuantLinear chain the model runs without ERAX_INT8_FF, and
  `torch._int_mm` alone for the two products on codes made beforehand;
- with `--serve`, int8 `generate_batch` of the smoke's eight texts at NFE 32
  on seeded reference-format checkpoints: F5TTS_v1_Base in bf16 / int8
  chain / int8 fused in turns, twice each after a warm-up, then E2TTS_Base
  int8 chain / fused (where the tree serves it), in seconds of audio per wall
  second.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

SHAPES = ((2, 768), (2, 1088), (16, 768))
WIDTHS = (2048, 4096)


def main(argv: list[str]) -> int:
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(argv[0]).resolve()
    tag = f"[{argv[0]}]"
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from eraxvif5tts_tpu_torch.ops import quant, quant_ff
    from eraxvif5tts_tpu_torch.tools.probe_gemm import burst_ms
    from eraxvif5tts_tpu_torch.tools.probe_train_attention import digest

    if Path(cs.__file__).resolve().parent != tree:
        raise RuntimeError(f"chip_smoke was imported from {cs.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        print("probe_int8_ff: no CUDA device", file=sys.stderr)
        return 2
    log = cs.log
    cs.log = lambda *a: log(tag, *a)
    cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda", 0)

    def operands(b, m, n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((b, m, 1024), generator=g, device=dev).bfloat16()
        w1_q, s1 = quant.quantize_weight(torch.randn((n, 1024), generator=g, device=dev) / 32)
        w2_q, s2 = quant.quantize_weight(torch.randn((1024, n), generator=g, device=dev) / 45)
        b1 = 0.1 * torch.randn((n,), generator=g, device=dev)
        b2 = 0.1 * torch.randn((1024,), generator=g, device=dev)
        return x, w1_q, s1, b1, w2_q, s2, b2

    def taken(args) -> bool:
        try:
            quant_ff.int8_ff(*args)
        except ValueError as err:
            cs.log(f"kernel 5 at N={args[1].shape[0]}: refused ({err})")
            return False
        return True

    for n in WIDTHS:
        args = operands(2, 300, n, 4321)
        if taken(args):
            codes = torch.empty((2, 300, n), dtype=torch.int8, device=dev)
            out = quant_ff.int8_ff(*args, h_codes=codes)
            torch.cuda.synchronize()
            cs.log(f"digests at [2, 300] N={n}: output {digest(out)}, hidden codes "
                   f"{digest(codes)}")
    for n in WIDTHS:
        for b, m in SHAPES:
            args = operands(b, m, n, 4321 + b * m)
            if not taken(args):
                break
            x_q = quant.quantize_rows(args[0].float())[0].view(b * m, 1024)
            h_q = quant_ff.hidden_codes(*args[:4])[0].view(b * m, n)
            w1_t, w2_t = args[1].t(), args[4].t()
            fns = {"kernel": lambda: quant_ff.int8_ff(*args),
                   "QuantLinear chain": lambda: cs.int8_chain(*args),
                   "torch._int_mm alone": lambda: (torch._int_mm(x_q, w1_t),
                                                   torch._int_mm(h_q, w2_t))}
            least = cs.bound(2 * b * m * 1024 * 2 + 2 * n * 1024 + 2 * (n + 1024) * 4,
                             2 * 2.0 * b * m * 1024 * n, "int8")
            cs.log(f"kernel 5 B={b} M={m} K=1024 N={n} K2=1024, median of single calls / mean of "
                   "50 back to back: "
                   + ", ".join(f"{name} {cs.cuda_median_ms(fn):.4f} / {burst_ms(fn):.4f} ms"
                               for name, fn in fns.items())
                   + f"; bound {least['bound_ms']:.5f} ms by {least['bound_by']}")
    if "--serve" in argv[1:]:
        serve(cs, dev)
    return 0


def serve(cs, dev) -> None:
    """int8 `generate_batch` of the smoke's eight texts (`--serve`)."""
    import statistics

    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    vocab = {c: i for i, c in enumerate(cs.VOCAB_CHARS)}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("F5TTS_v1_Base", "E2TTS_Base"):
            cfg = PRESETS[name]
            ckpt = Path(tmp) / f"{name}.pt"
            cs.save_reference_checkpoint(ckpt, cfg, dev)
            common = dict(model_cfg=cfg, ckpt_path=str(ckpt), vocab_char_map=vocab,
                          device=dev, nfe_step=cs.NFE)
            try:
                int8 = F5TTSWrapper(compute_dtype="int8", **common)
            except ValueError as err:
                cs.log(f"serve {name} int8: not served ({err})")
                continue
            wrappers = {"int8 chain": (int8, False), "int8 fused": (int8, True)}
            if name == "F5TTS_v1_Base":
                wrappers = {"bf16": (F5TTSWrapper(compute_dtype="bfloat16", **common), False),
                            **wrappers}
            for wrapper, _ in wrappers.values():
                cs.randomize((wrapper.vocoder,), cs.SEED)
                cs.load_reference(wrapper)
            rates = {label: [] for label in wrappers}

            def batch(label):
                wrapper, fused = wrappers[label]  # run_batch sets ERAX_INT8_FF as `fused` says
                _, wall, audio = cs.run_batch(wrapper, cfg.arch.depth, cs.NFE, cs.SEED + 4,
                                              fused, f"{name} {label}")
                return audio / wall

            for label in wrappers:  # warm-up: first calls at this bucket
                batch(label)
            for label in (*wrappers, *reversed(wrappers)):
                rates[label].append(batch(label))
            cs.log(f"serve {name} generate_batch of {len(cs.BATCH_TEXTS)} at NFE {cs.NFE}, "
                   "s of audio per wall s (two calls in turns): "
                   + "; ".join(f"{label} {statistics.mean(r):.3f} ({r[0]:.3f}, {r[1]:.3f})"
                               for label, r in rates.items()))
            del int8, wrappers


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
