"""Where a CTA of kernel 5 (`int8_ff`) spends its time, phase by phase.

    python3 eraxvif5tts_tpu_torch/tools/trace_int8_ff.py [TREE]

Builds TREE's `csrc/int8_ff.cu` (default: this checkout) a second time, with
``-DERAX_INT8_FF_TRACE``: thread 0 of every CTA then stamps the GPU's
nanosecond clock (`%globaltimer`) at the ends of the consumers' phases. The
package's own build never defines it. At (B, M) = (2, 768) and (16, 768),
K = K2 = 1024, N = 2048 and 4096, it prints the mean time of 50 launches back
to back, the traced launch's span, and per CTA the median of each phase:

- ``gemm1``: GEMM 1's products and loads; ``epi1``: dequantize, bias,
  tanh-GELU and the CTA's row maxima; ``bar1``: the cluster barrier after
  them; ``quant``: the peers' maxima through distributed shared memory, the
  scales, the codes into shared memory; ``bar2``: the cluster barrier
  before GEMM 2; ``gemm2``: GEMM 2, its A tiles copied out of the peers'
  shared memory; ``epi2``: the output's epilogue and the last cluster
  barrier;

and when the CTAs started, in quantiles of the span (the waves). A stamp is
one clock read and one store by one thread. Needs the card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

PHASES = ("gemm1", "epi1", "bar1", "quant", "bar2", "gemm2", "epi2")
SHAPES = ((2, 768, 2048), (16, 768, 2048), (2, 768, 4096), (16, 768, 4096))


def build(tree: Path) -> ctypes.CDLL:
    """TREE's kernel 5 with the stamps, as a library of its own."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    csrc = tree / "eraxvif5tts_tpu_torch" / "csrc"
    out = tree / "eraxvif5tts_tpu_torch" / "_build" / "trace"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libint8_ff_trace.so"
    flags = [f for f in _cuda.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([_cuda._nvcc(), *flags, "-shared", "-DERAX_INT8_FF_TRACE",
                    "-o", str(so), str(csrc / "int8_ff.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.erax_int8_ff.argtypes = (p,) * 11 + (i,) * 4 + (p,)
    lib.erax_int8_ff_stamps_read.argtypes = (p, i)
    return lib


def main(argv: list[str]) -> int:
    tree = Path(argv[0] if argv else ".").resolve()
    sys.path.insert(0, str(tree))
    import torch

    from eraxvif5tts_tpu_torch.ops import quant, quant_ff

    if not torch.cuda.is_available():
        print("trace_int8_ff: no CUDA device", file=sys.stderr)
        return 2
    lib = build(tree)
    dev = torch.device("cuda", 0)
    print(f"[{argv[0] if argv else '.'}] {torch.cuda.get_device_name(0)}", flush=True)
    for b, m, n in SHAPES:
        k = 1024
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((b, m, k), generator=g, device=dev).bfloat16()
        w1, s1 = quant.quantize_weight(torch.randn((n, k), generator=g, device=dev) / 32)
        w2, s2 = quant.quantize_weight(torch.randn((k, n), generator=g, device=dev) / 45)
        b1 = 0.1 * torch.randn((n,), generator=g, device=dev)
        b2 = 0.1 * torch.randn((k,), generator=g, device=dev)
        out = torch.empty((b, m, k), dtype=torch.bfloat16, device=dev)
        x_codes = torch.empty((b * m, k), dtype=torch.int8, device=dev)
        x_scales = torch.empty((b * m,), dtype=torch.float32, device=dev)
        ctas = quant_ff.int8_ff_grid(b * m, n)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call():
            code = lib.erax_int8_ff(x.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                                    w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                                    None, x_codes.data_ptr(), x_scales.data_ptr(), b * m, k, n,
                                    k, stream)
            if code != 0:
                raise RuntimeError(f"trace_int8_ff: launch failed (cudaError {code})")

        for _ in range(5):
            call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            call()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 50
        if not torch.equal(out, quant_ff.int8_ff_reference(x, w1, s1, b1, w2, s2, b2)):
            print(f"  note: B={b} M={m} N={n}: the traced build's output differs from the "
                  "plain version in the last bf16 bits", flush=True)
        call()
        torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * (8 * ctas))()
        if lib.erax_int8_ff_stamps_read(raw, ctas) != 0:
            raise RuntimeError("trace_int8_ff: reading the stamps failed")
        stamps = [[raw[c * 8 + i] for i in range(8)] for c in range(ctas)]
        t0 = min(s[0] for s in stamps)
        span_us = (max(s[7] for s in stamps) - t0) / 1e3
        phases = {name: statistics.median((s[i + 1] - s[i]) / 1e3 for s in stamps)
                  for i, name in enumerate(PHASES)}
        total = statistics.median((s[7] - s[0]) / 1e3 for s in stamps)
        starts = sorted((s[0] - t0) / 1e3 for s in stamps)
        q = [starts[min(int(f * len(starts)), len(starts) - 1)] for f in (0.0, 0.5, 0.9, 1.0)]
        print(f"B={b} M={m} K={k} N={n}: {ctas} CTAs in clusters of {n // quant_ff.SLAB}; "
              f"{ms:.4f} ms a launch (mean of 50 back to back); traced span {span_us:.1f} us; "
              f"a CTA's median {total:.1f} us: "
              + ", ".join(f"{name} {v:.2f}" for name, v in phases.items())
              + " us; CTA starts at 0 / 50 / 90 / 100 % of them: "
              + " / ".join(f"{v:.1f}" for v in q) + " us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
