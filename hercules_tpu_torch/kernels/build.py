"""Build the port's CUDA kernels and load them with ctypes.

All of ``hercules_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` into one
shared library with a plain C interface,
``build/hercules_tpu_torch/libhtkernels_<hash>.so`` at the root of the
checkout, on first use (the hash covers the sources and the flags, so
an edited source builds a new library).  Each source compiles in its
own ``nvcc`` process, all started together, and one more links the
objects.  A file lock serializes concurrent builds.  There is no
fallback: a missing toolkit or a failed build raises.

The library links the CUDA runtime statically and talks to the same
device (primary context) and streams as PyTorch: the wrappers pass
``tensor.data_ptr()`` and the current stream's handle (``stream``).

The launch path every wrapper shares: each C entry is resolved once,
when the library loads (``lib()``); a wrapper's argument checks run
once per call signature (``CheckCache``), so a repeat call with the
same tensors does only the stream lookup and the ctypes call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hercules_tpu_torch"

# sm_90a: Hopper with its architecture-specific features.  --fmad=false:
# the kernels spell every multiply-add as an fma intrinsic, and no other
# contraction may make two kernels round the shared body differently.
# -Xptxas -v: registers, shared memory and spills, kept in the build log.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points and their ctypes argument types (pointers and the
# stream as c_void_p, so 64-bit values are not cut to an int)
SIGNATURES = {
    "ht_brick_step_f32": [_P, _P, _P, _I, _P, _I, _P],
    "ht_brick_step_f64": [_P, _P, _P, _I, _P, _I, _P],
    "ht_brick_step_grid_f32": [_P, _I, _I, _P],
    "ht_brick_step_grid_f64": [_P, _I, _I, _P],
    "ht_brick_chunk_f32": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P,
                           _P, _I, _P, _I, _P],
    "ht_brick_chunk_f64": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P,
                           _P, _I, _P, _I, _P],
    "ht_stream_add_init": [_I],
    "ht_stream_add_f32": [_P, _P, _P, _L, _P],
    "ht_stream_add_inplace_f32": [_P, _P, _L, _P],
}
# entries called once, with the current device's index, when the
# library loads
ON_LOAD = ("ht_stream_add_init",)
# the BKT entries, one per (working type, memory-variable type) pair
SIGNATURES.update(
    {f"ht_bkt_step_{sfx}": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P]
     for sfx in ("f32_bf16", "f32_f32", "f64_f64")})
SIGNATURES.update(
    {f"ht_bkt_chunk_{sfx}": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P,
                             _P, _I, _P, _P, _P, _P, _I, _P, _I, _P]
     for sfx in ("f32_bf16", "f32_f32", "f64_f64")})
SIGNATURES.update(
    {f"ht_bkt_node_set_tab_{t}": [_P, _I, _P] for t in ("f32", "f64")})
SIGNATURES.update(
    {f"ht_bkt_node_step_{sfx}": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _P, _I, _I, _P]
     for sfx in ("f32_bf16", "f32_f32", "f64_f64")})
SIGNATURES.update(
    {f"ht_bkt_corner_set_tab_{t}": [_P, _I, _P] for t in ("f32", "f64")})
SIGNATURES.update(
    {f"ht_bkt_corner_step_{sfx}": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _P]
     for sfx in ("f32_bf16", "f64_f64")})
SIGNATURES.update(
    {f"ht_bkt_corner_grid_{sfx}": [_P, _I, _I, _I, _P]
     for sfx in ("f32_bf16", "f64_f64")})

_LIB = None
# wall seconds this process spent compiling (None: the library was
# already built)
build_seconds = None


# where the CUDA toolkit is looked for after $CUDA_HOME, before $PATH
CUDA_ROOTS = ("/usr/local/cuda",)


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled on first use "
            "with the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libhtkernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the library unless it exists; returns its
    path.  The compiler's output is kept beside it (``.log``)."""
    global build_seconds
    so = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            t0 = time.perf_counter()
            objdir = BUILD_DIR / f"{so.stem}.obj{os.getpid()}"
            objdir.mkdir(exist_ok=True)
            try:
                _compile_and_link(so, objdir)
            finally:
                shutil.rmtree(objdir, ignore_errors=True)
            build_seconds = time.perf_counter() - t0
    return so


def _compile_and_link(so, objdir):
    """One nvcc per source, all at once, then the link; the compilers'
    output goes to the library's ``.log``."""
    nvcc = nvcc_path()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [objdir / f"{f.stem}.o" for f in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(f), "-o", str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for f, o in zip(srcs, objs)]
    logs = [(f.name, p.communicate()[0], p.returncode)
            for f, p in zip(srcs, procs)]
    text = "".join(f"== {name} (exit {rc})\n{out}" for name, out, rc in logs)
    so.with_suffix(".log").write_text(text)
    bad = [(name, out, rc) for name, out, rc in logs if rc != 0]
    if bad:
        raise RuntimeError("nvcc failed:\n" + "".join(
            f"{name}: exit code {rc}\n{out[-3000:]}" for name, out, rc in bad))
    tmp = so.with_name(f"{so.stem}.tmp{os.getpid()}.so")
    r = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                        *(str(o) for o in objs)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed with exit code "
                           f"{r.returncode}:\n{r.stderr[-4000:]}")
    os.replace(tmp, so)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), every entry of
    SIGNATURES resolved with its argument types, and the ON_LOAD
    entries run."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in ON_LOAD:
            check(getattr(handle, name)(torch.cuda.current_device()), name)
        _LIB = handle
    return _LIB


def entry(name: str):
    """The C entry ``name``, resolved (and the library loaded) once."""
    return getattr(lib(), name)


# the current stream's handle and the current device without the
# Python layers of torch.cuda (one C call each); builds without CUDA
# lack them and never launch
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_GET_DEVICE = getattr(torch._C, "_cuda_getDevice", None)


def stream(t) -> int:
    """Handle of the current CUDA stream on tensor t's device."""
    return _RAW_STREAM(t.get_device())


def current_device() -> int:
    """Index of the current CUDA device."""
    return _GET_DEVICE()


def signature(args) -> tuple:
    """The key a call's checks are kept under, one flat tuple: for every
    tensor its data pointer, shape, strides, dtype and device; every
    other argument as it is (it must be hashable)."""
    key = []
    for a in args:
        if isinstance(a, torch.Tensor):
            key += (a.data_ptr(), a.shape, a.stride(), a.dtype, a.device)
        else:
            key.append(a)
    return tuple(key)


class CheckCache:
    """A wrapper's argument checks, kept per call signature.

    ``check(*args)`` raises on arguments its kernel does not take, else
    returns what the launch needs besides the stream (the C entry and
    its arguments; never None).  Calling the cache with the same
    arguments returns that, running ``check`` only for a signature
    (``signature``) it has not kept.  The checks may depend on nothing
    but the signature, so a kept one stands for every call that has it:
    a tensor that changed shape, strides, dtype, device or memory has
    another.  A refused call raises and keeps nothing.  At most ``size``
    signatures are kept, the oldest dropped first."""

    def __init__(self, check, size=64):
        self.check = check
        self.size = size
        self.kept = {}

    def __call__(self, *args):
        key = signature(args)
        got = self.kept.get(key)
        if got is None:
            got = self.check(*args)
            if len(self.kept) >= self.size:
                del self.kept[next(iter(self.kept))]
            self.kept[key] = got
        return got


def check(rc: int, what: str):
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def offsets_arg(offs):
    """The 8 corner offsets as the C entries' host int[8]."""
    return (ctypes.c_int * 8)(*(int(o) for o in offs))


def overlap(a, b) -> bool:
    """True if the memory spans of tensors a and b intersect (from
    their data pointers, sizes and strides alone)."""
    def span(t):
        lo = t.data_ptr()
        n = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))
        return lo, lo + (n if t.numel() else 0) * t.element_size()
    (a0, a1), (b0, b1) = span(a), span(b)
    return a0 < b1 and b0 < a1


# operator tensor last uploaded by each constant-bank setter (K3's
# ht_bkt_node_set_tab_*, K4's ht_bkt_corner_set_tab_*), with its version
# counter: the constant bank is refreshed only when a different (or
# modified) tensor is passed.  Holding the tensor keeps its device
# address from being reused by another allocation.
_UPLOADED = {}


def ensure_ops(setter: str, ops, stream: int):
    held = _UPLOADED.get(setter)
    if held is not None and held[0] is ops and held[1] == ops._version:
        return
    check(getattr(lib(), setter)(ops.data_ptr(), ops.device.index, stream),
          setter)
    _UPLOADED[setter] = (ops, ops._version)
