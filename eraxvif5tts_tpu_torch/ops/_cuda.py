"""Build and load the port's CUDA kernels (`csrc/*.cu`).

``nvcc`` compiles each source under `csrc/` to an object for ``sm_90a``, all
sources at once in parallel processes, then links the objects into one shared
library with a plain C interface, loaded with ``ctypes``. The build goes to
`eraxvif5tts_tpu_torch/_build/` (ignored by git), keyed by a hash of the
sources and flags, at first use — never at import, so the CPU tests import
every module on a machine without ``nvcc``. The flags leave out
``--use_fast_math``: it would turn the int8 kernels' divisions into
reciprocal products and ``tanhf`` into an approximation, and move their
quantization codes.

Each C entry point launches on the stream it is handed, allocates nothing,
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into
an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
_DROPOUT = (_U, _U, _F, _I)  # seed, threshold, inv_keep, dropout on
_SIGNATURES = {
    # q, k, v, lens, cos, sin, out, b, n, h, roped, scale, stream
    "erax_serving_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # x, scale, shift, w, bias, out, stats, b, m, k, n, gelu, norm, eps, stream
    "erax_ln_mod_matmul": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, lens, out, lse, b, n, h, scale, dropout..., stream
    "erax_train_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, *_DROPOUT, _P),
    # q, k, v, dout, lse, dd, lens, dq, b, n, h, scale, dropout..., stream
    "erax_train_attention_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, *_DROPOUT,
                                _P),
    # q, k, v, dout, lse, dd, lens, dk, dv, b, n, h, scale, dropout..., stream
    "erax_train_attention_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                                 *_DROPOUT, _P),
    # x, w1, s1, b1, w2, s2, b2, out, hidden codes, rows, k, n, k2, shared bytes, stream
    "erax_int8_ff": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # h, w, bias, gate, res, lens, out, b, m, k, n, mask_rows, stream
    "erax_matmul_gate_res": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


@dataclass(frozen=True)
class Kernels:
    """The loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    built: bool          # False when a cached build was loaded
    seconds: float       # nvcc wall time (0 for a cached build)
    log: str             # nvcc's output (register / shared-memory report)


_lock = threading.Lock()
_loaded: Kernels | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from csrc/ at first use")
    return str(path)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(so: Path) -> str:
    """Compile every `csrc/*.cu` to an object in parallel, link them into
    ``so``; returns nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objects, procs = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objects.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for name, proc in procs:
        out = proc.communicate()[0]
        log += out
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode})")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
        tmp = so.with_suffix(f".{tag}")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared",
                               "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return log


def kernels() -> Kernels:
    """Build (once per source hash) and load the kernel library."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        so = BUILD_DIR / f"liberax_kernels_{_digest()}.so"
        built, seconds, log = False, 0.0, ""
        if not so.exists():
            t0 = time.perf_counter()
            log = _build(so)
            seconds = time.perf_counter() - t0
            built = True
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.erax_error_string.argtypes = (ctypes.c_int,)
        lib.erax_error_string.restype = ctypes.c_char_p
        _loaded = Kernels(lib=lib, path=so, built=built, seconds=seconds, log=log)
        return _loaded


def check(code: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = kernels().lib.erax_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} (cudaError {code})")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
