"""ctypes loader for the native meshing kernels (cpp/meshkernels.cpp).

Compiles on first use into a cached shared library; all callers fall
back to the NumPy implementations when the toolchain is unavailable,
so the package works without native support (just slower host
meshing).

The port's copy of ``hercules_tpu/native.py``, with two changes: the
source is the port's own ``hercules_tpu_torch/cpp/meshkernels.cpp``
(a copy of the JAX package's ``cpp/meshkernels.cpp``), and the library
builds into ``build/hercules_tpu_torch/`` at the root of the checkout,
beside the CUDA kernels, instead of a cache under the home directory."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp",
                    "meshkernels.cpp")
_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "hercules_tpu_torch")


def _build():
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_CACHE, exist_ok=True)
    so = os.path.join(_CACHE, f"meshkernels_{tag}.so")
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
               "-march=native", "-pthread", _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def get_lib():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("HT_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(_build())
    except Exception as e:  # toolchain missing etc.
        print(f"hercules_tpu_torch: native kernels unavailable ({e}); "
              f"using NumPy fallbacks", file=sys.stderr)
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.ht_interleave3.argtypes = [u32p, u32p, u32p, u64p, u64p, i64]
    lib.ht_deinterleave3.argtypes = [u64p, u64p, u32p, u32p, u32p, i64]
    lib.ht_sort_perm_u128.argtypes = [u64p, u64p, i64, i64p]
    lib.ht_floor_search.argtypes = [u64p, u64p, i64, u64p, u64p, i64,
                                    i64p]
    lib.ht_exact_search.argtypes = [u64p, u64p, i64, u64p, u64p, i64,
                                    i64p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ht_etree_search.argtypes = [u64p, u64p, u8p, i64, u32p, u32p,
                                    u32p, i64, i64p]
    lib.ht_corner_keys.argtypes = [u32p, u32p, u32p, i64p, i64,
                                   i64, i64, i64, u64p, u64p]
    lib.ht_balance_scan.argtypes = [u64p, u64p, u8p, i64, i64p, i64,
                                    i64, i64, i64, i64, u8p, u8p]
    i32p_ = ctypes.POINTER(ctypes.c_int32)
    lib.ht_group_ids.argtypes = [u64p, u64p, i64p, i64, i32p_, u8p]
    lib.ht_dangling_scan.argtypes = [u64p, u64p, i64,
                                     u32p, u32p, u32p, i64p, i64,
                                     i64, i64, i64,
                                     i64p, i64p, u8p]
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64 = ctypes.c_double
    i32 = ctypes.c_int32
    lib.ht_cvm_sample27.argtypes = [
        f64p, f64p, f64p, f64p, i64,
        f64, f64, f64, f64, f64,
        f64p, f64,
        i64, i64, i64,
        i32p, i32, i64,
        f64p, f64p, f64p,
        i32,
        f64p, f64p, f64p, i32p]
    _LIB = lib
    return _LIB


def _p(a, t):
    return a.ctypes.data_as(t)


def interleave3(x, y, z):
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.uint32)
    y = np.ascontiguousarray(y, np.uint32)
    z = np.ascontiguousarray(z, np.uint32)
    n = len(x)
    hi = np.empty(n, np.uint64)
    lo = np.empty(n, np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.ht_interleave3(_p(x, u32p), _p(y, u32p), _p(z, u32p),
                       _p(hi, u64p), _p(lo, u64p), n)
    return hi, lo


def deinterleave3(hi, lo):
    lib = get_lib()
    if lib is None:
        return None
    hi = np.ascontiguousarray(hi, np.uint64)
    lo = np.ascontiguousarray(lo, np.uint64)
    n = len(hi)
    x = np.empty(n, np.uint32)
    y = np.empty(n, np.uint32)
    z = np.empty(n, np.uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.ht_deinterleave3(_p(hi, u64p), _p(lo, u64p), _p(x, u32p),
                         _p(y, u32p), _p(z, u32p), n)
    return x, y, z


def floor_search(shi, slo, qhi, qlo):
    lib = get_lib()
    if lib is None:
        return None
    shi = np.ascontiguousarray(shi, np.uint64)
    slo = np.ascontiguousarray(slo, np.uint64)
    qhi = np.ascontiguousarray(np.atleast_1d(qhi), np.uint64)
    qlo = np.ascontiguousarray(np.atleast_1d(qlo), np.uint64)
    out = np.empty(len(qhi), np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ht_floor_search(_p(shi, u64p), _p(slo, u64p), len(shi),
                        _p(qhi, u64p), _p(qlo, u64p), len(qhi),
                        _p(out, i64p))
    return out


def exact_search(shi, slo, qhi, qlo):
    lib = get_lib()
    if lib is None:
        return None
    shi = np.ascontiguousarray(shi, np.uint64)
    slo = np.ascontiguousarray(slo, np.uint64)
    qhi = np.ascontiguousarray(np.atleast_1d(qhi), np.uint64)
    qlo = np.ascontiguousarray(np.atleast_1d(qlo), np.uint64)
    out = np.empty(len(qhi), np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ht_exact_search(_p(shi, u64p), _p(slo, u64p), len(shi),
                        _p(qhi, u64p), _p(qlo, u64p), len(qhi),
                        _p(out, i64p))
    return out


def sort_perm(hi, lo):
    lib = get_lib()
    if lib is None:
        return None
    hi = np.ascontiguousarray(hi, np.uint64)
    lo = np.ascontiguousarray(lo, np.uint64)
    out = np.empty(len(hi), np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ht_sort_perm_u128(_p(hi, u64p), _p(lo, u64p), len(hi),
                          _p(out, i64p))
    return out


def dangling_scan(nhi, nlo, bx, by, bz, be, farendp):
    """Fused dangling-candidate scan (ht_dangling_scan): returns
    (nid [nb, 18], anchors [nb, 18, 4], deps [nb, 18]) in
    extract.py's candidate case order, or None without the native
    library."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ht_dangling_scan"):
        return None
    nhi = np.ascontiguousarray(nhi, np.uint64)
    nlo = np.ascontiguousarray(nlo, np.uint64)
    bx = np.ascontiguousarray(bx, np.uint32)
    by = np.ascontiguousarray(by, np.uint32)
    bz = np.ascontiguousarray(bz, np.uint32)
    be = np.ascontiguousarray(be, np.int64)
    nb = len(be)
    nid = np.empty((nb, 18), np.int64)
    anc = np.empty((nb, 18, 4), np.int64)
    deps = np.empty((nb, 18), np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ht_dangling_scan(
        _p(nhi, u64p), _p(nlo, u64p), len(nhi),
        _p(bx, u32p), _p(by, u32p), _p(bz, u32p), _p(be, i64p), nb,
        int(farendp[0]), int(farendp[1]), int(farendp[2]),
        _p(nid, i64p), _p(anc, i64p), _p(deps, u8p))
    return nid, anc, deps


def group_ids(hi, lo, order):
    """Fused extraction group-id pass (ht_group_ids): returns
    (gid int32 [n] in ORIGINAL index order, first bool [n] in sorted
    positions), or None without the native library."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ht_group_ids"):
        return None
    hi = np.ascontiguousarray(hi, np.uint64)
    lo = np.ascontiguousarray(lo, np.uint64)
    order = np.ascontiguousarray(order, np.int64)
    n = len(order)
    gid = np.empty(n, np.int32)
    first = np.empty(n, np.uint8)
    lib.ht_group_ids(
        _p(hi, ctypes.POINTER(ctypes.c_uint64)),
        _p(lo, ctypes.POINTER(ctypes.c_uint64)),
        _p(order, ctypes.POINTER(ctypes.c_int64)), n,
        _p(gid, ctypes.POINTER(ctypes.c_int32)),
        _p(first, ctypes.POINTER(ctypes.c_uint8)))
    return gid, first.astype(bool)


def balance_scan(hi, lo, level, src, farendp, minlv=0):
    """Fused 2:1-balance probe scan (ht_balance_scan): returns
    (split mask over the sorted leaves, triggered mask over src) —
    probing only from the `src` leaf indices, floor searches galloped
    out from each source's own position (Morton locality), sources at
    the two coarsest levels skipped (they can never find a >=2-coarser
    neighbor).  None when the native library is missing."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ht_balance_scan"):
        return None
    hi = np.ascontiguousarray(hi, np.uint64)
    lo = np.ascontiguousarray(lo, np.uint64)
    level = np.ascontiguousarray(level, np.uint8)
    src = np.ascontiguousarray(src, np.int64)
    out = np.zeros(len(level), np.uint8)
    trig = np.zeros(max(len(src), 1), np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ht_balance_scan(
        _p(hi, u64p), _p(lo, u64p), _p(level, u8p), len(level),
        _p(src, i64p), len(src),
        int(farendp[0]), int(farendp[1]), int(farendp[2]),
        int(minlv),
        _p(out, u8p), _p(trig, u8p))
    return out.astype(bool), trig[:len(src)].astype(bool)


def corner_keys(x, y, z, e, farendp):
    """Morton keys of the 8 clamped corners of each element, [8E]
    arrays (hi, lo) in element-major which-order; None without the
    native library."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ht_corner_keys"):
        return None
    x = np.ascontiguousarray(x, np.uint32)
    y = np.ascontiguousarray(y, np.uint32)
    z = np.ascontiguousarray(z, np.uint32)
    e = np.ascontiguousarray(e, np.int64)
    n = len(x)
    hi = np.empty(8 * n, np.uint64)
    lo = np.empty(8 * n, np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ht_corner_keys(_p(x, u32p), _p(y, u32p), _p(z, u32p),
                       _p(e, i64p), n, int(farendp[0]),
                       int(farendp[1]), int(farendp[2]),
                       _p(hi, u64p), _p(lo, u64p))
    return hi, lo


def cvm_sample27(X, Y, Z, half_or_edge, ts, origin_xyz, zshift, fr,
                 cts, endpoints, dense, sh, cols, mode):
    """Fused 27-point CVM sampling (see ht_cvm_sample27): returns
    (vp, vs, rho, ok) per element — min-Vs reduction (mode 0, setrec)
    or 27-sample sums + ok count (mode 1, correct_properties).
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ht_cvm_sample27"):
        return None
    X = np.ascontiguousarray(X, np.float64)
    Y = np.ascontiguousarray(Y, np.float64)
    Z = np.ascontiguousarray(Z, np.float64)
    he = np.ascontiguousarray(half_or_edge, np.float64)
    fr = np.ascontiguousarray(fr, np.float64)
    dense = np.ascontiguousarray(dense, np.int32)
    cvp, cvs, crho = (np.ascontiguousarray(c, np.float64)
                      for c in cols)
    n = len(X)
    ovp = np.empty(n, np.float64)
    ovs = np.empty(n, np.float64)
    orho = np.empty(n, np.float64)
    ook = np.empty(n, np.int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ht_cvm_sample27(
        _p(X, f64p), _p(Y, f64p), _p(Z, f64p), _p(he, f64p), n,
        float(ts), float(origin_xyz[0]), float(origin_xyz[1]),
        float(origin_xyz[2]), float(zshift),
        _p(fr, f64p), float(cts),
        int(endpoints[0]), int(endpoints[1]), int(endpoints[2]),
        _p(dense, i32p), int(sh), len(dense),
        _p(cvp, f64p), _p(cvs, f64p), _p(crho, f64p),
        int(mode),
        _p(ovp, f64p), _p(ovs, f64p), _p(orho, f64p), _p(ook, i32p))
    return ovp, ovs, orho, ook


def etree_search(shi, slo, slevel, qx, qy, qz):
    """Fused etree point lookup: interleave + floor + ancestor check in
    one parallel C++ pass.  Returns leaf index or -1 per query."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ht_etree_search"):
        return None
    import ctypes
    shi = np.ascontiguousarray(shi, np.uint64)
    slo = np.ascontiguousarray(slo, np.uint64)
    slevel = np.ascontiguousarray(slevel, np.uint8)
    qx = np.ascontiguousarray(np.atleast_1d(qx), np.uint32)
    qy = np.ascontiguousarray(np.atleast_1d(qy), np.uint32)
    qz = np.ascontiguousarray(np.atleast_1d(qz), np.uint32)
    out = np.empty(len(qx), np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ht_etree_search(_p(shi, u64p), _p(slo, u64p), _p(slevel, u8p),
                        len(shi), _p(qx, u32p), _p(qy, u32p),
                        _p(qz, u32p), len(qx), _p(out, i64p))
    return out
