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
an exception. The attention and GEMM kernels build their TMA tensor maps on
the host with libcuda's ``cuTensorMapEncodeTiled``, which they fetch at
run time through ``cudaGetDriverEntryPoint``: the link names no extra
library, and a refused map comes back as a non-zero code like any other.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
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
_DROPOUT = (_U, _U, _F, _I, _U, _U)  # seed, threshold, inv_keep, dropout on, b / h offsets
_SIGNATURES = {
    # q, k, v, lens, cos, sin, out, b, n, h, d, roped, scale, stream
    "erax_serving_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "erax_serving_attention_fp32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # x, scale, shift, w, bias, out, stats, b, m, k, n, gelu, norm, eps, stream
    "erax_ln_mod_matmul": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, lens, out, lse, b, n, h, d, scale, dropout..., stream
    "erax_train_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, *_DROPOUT, _P),
    # q, k, v, dout, lse, dd, lens, dq, b, n, h, d, scale, dropout..., stream
    "erax_train_attention_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                *_DROPOUT, _P),
    # q, k, v, dout, lse, dd, lens, dk, dv, b, n, h, d, scale, dropout..., stream
    "erax_train_attention_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                 *_DROPOUT, _P),
    # the fp32 modes of the three (`csrc/train_attention_fp32.cu`), the same arguments
    "erax_train_attention_fp32_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, *_DROPOUT,
                                      _P),
    "erax_train_attention_fp32_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                     *_DROPOUT, _P),
    "erax_train_attention_fp32_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                      *_DROPOUT, _P),
    # x, w1, s1, b1, w2, s2, b2, out, hidden codes, x codes, x scales, rows, k, n, k2, stream
    "erax_int8_ff": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
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
# Every wrapper bumps its launch counters under this lock (through
# :func:`count`): several threads may launch at once (the HTTP server's
# generations), and ``+=`` on an attribute is a read and a write another
# thread can come between.
COUNT_LOCK = threading.Lock()
# The CUDA graph capture under way on this thread, if any (:func:`capture`).
_capture = threading.local()


@dataclass
class Capture:
    """What the kernels' wrappers record while a CUDA graph is captured on
    this thread: ``launches``, the counter increments that one replay of the
    graph stands for (``{(fn, name): n}``, as :func:`count` takes them), and
    ``held``, the tensors a kernel reads from a host cache, which must live as
    long as the graph does (a cache may drop them; the graph keeps their
    addresses)."""

    launches: dict = field(default_factory=dict)
    held: list = field(default_factory=list)


@contextlib.contextmanager
def capture():
    """Record into a fresh :class:`Capture` for the block: a wrapper that
    launches inside it adds its counts there instead of to its counters (a
    capture launches nothing; :func:`add_launches` adds them at each replay)."""
    record = Capture()
    _capture.record = record
    try:
        yield record
    finally:
        _capture.record = None


def _bump(fn, name, n: int) -> None:
    if isinstance(name, tuple):  # (attribute, key) of a dict of counters
        getattr(fn, name[0])[name[1]] += n
    else:
        setattr(fn, name, getattr(fn, name) + n)


def count(fn, *names) -> None:
    """One launch of ``fn``'s kernel: add one to each counter in ``names``
    (an attribute of ``fn``, or ``(attribute, key)`` of a dict attribute).
    Inside :func:`capture` on this thread the launch is recorded for the
    graph instead."""
    record = getattr(_capture, "record", None)
    if record is not None:
        for name in names:
            record.launches[fn, name] = record.launches.get((fn, name), 0) + 1
        return
    with COUNT_LOCK:
        for name in names:
            _bump(fn, name, 1)


def add_launches(launches: dict) -> None:
    """Add one replay's launches, as :attr:`Capture.launches` holds them."""
    with COUNT_LOCK:
        for (fn, name), n in launches.items():
            _bump(fn, name, n)


def hold(*tensors) -> None:
    """Keep ``tensors`` (read by a kernel, taken from a host cache) alive as
    long as the graph being captured on this thread; outside a capture,
    nothing."""
    record = getattr(_capture, "record", None)
    if record is not None:
        record.held.extend(t for t in tensors if t is not None)


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
        # d, out[...]: an attention kernel's constants at head dim d (non-zero
        # for a head dim it has no instantiation of)
        for name in ("erax_train_attention_bwd_geometry", "erax_flash_forward_geometry",
                     "erax_train_attention_fp32_geometry",
                     "erax_serving_attention_fp32_geometry"):
            fn = getattr(lib, name)
            fn.argtypes = (_I, ctypes.POINTER(ctypes.c_int))
            fn.restype = ctypes.c_int
        # b, m, n, out[10]: the GEMM core's constants and its choice for a shape
        lib.erax_gemm_geometry.argtypes = (_I, _I, _I, ctypes.POINTER(ctypes.c_int))
        lib.erax_gemm_geometry.restype = None
        # k, n, k2, out[11]: kernel 5's constants and its cluster for a shape
        lib.erax_int8_ff_geometry.argtypes = (_I, _I, _I, ctypes.POINTER(ctypes.c_int))
        lib.erax_int8_ff_geometry.restype = None
        # base, b, n, h, iters -> host nanoseconds of one tensor-map encode
        lib.erax_tensor_map_encode_ns.argtypes = (_P, _I, _I, _I, _I)
        lib.erax_tensor_map_encode_ns.restype = ctypes.c_double
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
