"""Digests and times of the attention kernels of one tree of the repository,
to compare two trees (a commit and its parent) on one card.

    python3 eraxvif5tts_tpu_torch/tools/probe_train_attention.py TREE [--step] [--serve]

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
"""

from __future__ import annotations

import hashlib
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
