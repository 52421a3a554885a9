"""Checkpoint / restart (io_checkpoint.c:29-236).

The reference alternates two files checkpoint.out{0,1}, writing a tiny
header plus fixed-stride tm1/tm2 slabs per PE, and restarts only with
an identical rank count; BKT convolution state is NOT saved (a known
gap, SURVEY.md section 5).  This implementation keeps the alternating
double-buffer protocol and the checkpoint.in restart convention but
stores the *global* state (u_now, u_prev, plus the BKT convolution
arrays and the nonlinear plastic state when present), so restarts are
rank-elastic and bit-exact for all damping and material models.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

MAGIC = b"HTPUCKPT1"

# ---- async writer (one ordered worker, like the 4-D/plane threads;
# the reference overlaps output with compute via its IO pool) --------
_q: queue.Queue = None
_worker: threading.Thread = None


def _ensure_worker():
    global _q, _worker
    if _worker is None or not _worker.is_alive():
        _q = queue.Queue(maxsize=2)

        def loop():
            while True:
                item = _q.get()
                if item is None:
                    _q.task_done()
                    return
                fn, args = item
                try:
                    fn(*args)
                finally:
                    _q.task_done()

        _worker = threading.Thread(target=loop, daemon=True)
        _worker.start()


def checkpoint_write_async(path_dir, step, state, extra=None):
    """Queue a checkpoint write on the background writer thread.  The
    device arrays are snapshotted to host first (cheap relative to the
    npz serialization + disk write this overlaps)."""
    u_now, u_prev, conv = state
    snap = (np.asarray(u_now), np.asarray(u_prev),
            _tree_asarray(conv))
    _ensure_worker()
    _q.put((checkpoint_write, (path_dir, step, snap, extra)))


def checkpoint_flush():
    """Block until all queued checkpoint writes hit disk."""
    if _q is not None:
        _q.join()


def _tree_asarray(t):
    if t is None:
        return None
    if isinstance(t, (tuple, list)):
        return tuple(_tree_asarray(x) for x in t)
    return np.asarray(t)


def checkpoint_write(path_dir, step, state, extra=None):
    """Write checkpoint for `step` to the alternating output file.

    state: (u_now, u_prev, conv) with u [N,3] or [3,N]; conv pytree of
    arrays or ().
    """
    os.makedirs(path_dir, exist_ok=True)
    which = _next_slot(path_dir)
    path = os.path.join(path_dir, f"checkpoint.out{which}")
    tmp = path + ".tmp"
    u_now, u_prev, conv = state
    arrays = {"u_now": np.asarray(u_now), "u_prev": np.asarray(u_prev)}
    flat, _ = _flatten(conv)
    for i, a in enumerate(flat):
        arrays[f"conv{i}"] = np.asarray(a)
    if extra:
        arrays.update({k: np.asarray(v) for k, v in extra.items()})
    with open(tmp, "wb") as f:
        np.savez(f, step=np.int64(step), **arrays)
    os.replace(tmp, path)
    return path


def _next_slot(path_dir):
    """Alternate between slots 0 and 1, overwriting the older one."""
    t = []
    for w in (0, 1):
        p = os.path.join(path_dir, f"checkpoint.out{w}")
        t.append(os.path.getmtime(p) if os.path.exists(p) else -1.0)
    return 0 if t[0] <= t[1] else 1


def checkpoint_read(path, gnid_maps=None):
    """Read ``checkpoint.in`` (the operator renames the chosen .out, as
    in the reference) or a direct file path.

    Accepts BOTH formats: this package's npz checkpoint and the
    reference's raw binary (io_checkpoint.c:29-236), sniffed by the
    leading bytes (npz is a ZIP, ``PK``; the reference file starts with
    the int32 PE count).  A reference file restores tm1/tm2 only; BKT
    convolution and nonlinear state come back empty (zero-initialized
    by the caller), exactly the information a C-Hercules restart has.

    Returns (start_step, u_now, u_prev, conv_arrays list, extras dict).
    """
    if os.path.isdir(path):
        path = os.path.join(path, "checkpoint.in")
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":
        step, u_now, u_prev = read_reference_checkpoint(path, gnid_maps)
        return step, u_now, u_prev, [], {}
    with np.load(path) as z:
        step = int(z["step"])
        u_now = z["u_now"]
        u_prev = z["u_prev"]
        conv = []
        i = 0
        while f"conv{i}" in z:
            conv.append(z[f"conv{i}"])
            i += 1
        extras = {k: z[k] for k in z.files
                  if not (k in ("step", "u_now", "u_prev")
                          or k.startswith("conv"))}
    return step, u_now, u_prev, conv, extras


# ---- reference-format (C Hercules) checkpoint interop --------------
#
# Layout (io_checkpoint.c): header = 3 native int32 (groupsize, step,
# nharboredmax), then per PE a fixed-stride slab at
#   offset = 12 + 2*pe*nharboredmax*sizeof(fvector_t)
# holding two [nharbored, 3] solver_float fields.  Field roles: the
# writer runs AFTER the loop-top tm1/tm2 swap (psolve.c:4267-4273) and
# writes mySolver->tm2 then tm1 (io_checkpoint.c:100-117), so file
# slab0 = u(step-1) and slab1 = u(step); checkpoint_read loads slab0
# into tm1 / slab1 into tm2 and the resumed loop's first swap makes
# tm1 = u(step) current again (io_checkpoint.c:209-224).  Hence
# slab1 -> u_now, slab0 -> u_prev, resume at header step.
# solver_float is double, or float under -DSINGLE_PRECISION_SOLVER
# (psolve.h:60-63); the element width is recovered from the file size.


def _ref_layout(path):
    """(groupsize, step, nharboredmax, float width) of a reference
    checkpoint file, validating the size equation.

    The reference writer seeks each PE to its fixed-stride offset but
    the file simply ENDS after the last PE's 2*nharbored vectors
    (io_checkpoint.c:92-117) — when the last PE harbors fewer than
    nharboredmax nodes the file is shorter than the full stride.  So
    accept any size in (stride(gs-1), stride(gs)] for a width, trying
    the default double first (-DSINGLE_PRECISION_SOLVER is the
    opt-in, psolve.h:60-63)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        gs, step, nmax = np.fromfile(f, "<i4", 3)
    gs_i, nmax_i = int(gs), int(nmax)
    cands = []
    for w in (8, 4):
        full = 12 + 2 * gs_i * nmax_i * 3 * w
        prev = 12 + 2 * (gs_i - 1) * nmax_i * 3 * w
        # the trailing (possibly short) last-PE slab must hold a whole
        # number of node vector pairs — this disambiguates most exact
        # single-precision files from short double ones
        if prev < size <= full and (size - prev) % (6 * w) == 0:
            cands.append(w)
    if len(cands) > 1:
        # both widths fit the size equations: sniff the data — node
        # displacements are meters, while f4 pairs reinterpreted as f8
        # (or f8 halves as f4) produce absurd exponents or non-finite
        # values.  Keep widths whose leading values look physical.
        with open(path, "rb") as f:
            f.seek(12)
            raw = f.read(min(8192, size - 12))
        ok = []
        for w in cands:
            v = np.frombuffer(raw[: len(raw) - len(raw) % w],
                              "<f8" if w == 8 else "<f4")
            if v.size and np.all(np.isfinite(v)) and \
                    float(np.max(np.abs(v), initial=0.0)) < 1e20:
                ok.append(w)
        cands = ok or cands
    if cands:
        return gs_i, int(step), nmax_i, cands[0]
    raise ValueError(
        f"{path}: not a reference checkpoint (header gs={gs} "
        f"nharboredmax={nmax} matches no float width for size {size})")


def read_reference_checkpoint(path, gnid_maps=None):
    """Import a C-Hercules ``checkpoint.in`` (io_checkpoint.c:136-236).

    gnid_maps: for a file written by an N-PE run, a length-N list of
    int arrays mapping each PE's local (harbored) node order to global
    node ids — shared nodes carry identical values on every harboring
    PE, so overlapping writes agree.  A single-PE file (the common
    migration case: local node order IS the global Z-order) needs no
    map.  Returns (start_step, u_now [N,3] f64, u_prev [N,3] f64).
    """
    gs, step, nmax, w = _ref_layout(path)
    ft = "<f4" if w == 4 else "<f8"
    if gnid_maps is None:
        if gs != 1:
            raise ValueError(
                f"{path} was written by {gs} PEs; pass gnid_maps "
                "(per-PE local->global node id arrays) to import it")
        gnid_maps = [np.arange(nmax, dtype=np.int64)]
    if len(gnid_maps) != gs:
        raise ValueError(f"gnid_maps has {len(gnid_maps)} entries for "
                         f"a {gs}-PE checkpoint")
    nn = 1 + max(int(np.max(m)) for m in gnid_maps if len(m))
    u_now = np.zeros((nn, 3))
    u_prev = np.zeros((nn, 3))
    with open(path, "rb") as f:
        for pe, m in enumerate(gnid_maps):
            nh = len(m)
            if nh > nmax:
                raise ValueError(f"PE {pe}: {nh} harbored nodes > "
                                 f"file nharboredmax {nmax}")
            f.seek(12 + 2 * pe * nmax * 3 * w)
            slab = np.fromfile(f, ft, 2 * nh * 3)
            if slab.size != 2 * nh * 3:
                raise ValueError(
                    f"PE {pe}: file ends after {slab.size // 6} of "
                    f"{nh} harbored nodes (gnid_maps mismatch?)")
            slab = slab.reshape(2, nh, 3)
            u_prev[m] = slab[0]
            u_now[m] = slab[1]
    return step, u_now, u_prev


def write_reference_checkpoint(path, step, u_now, u_prev,
                               gnid_maps=None, single_precision=False):
    """Write the reference's binary checkpoint format so a state from
    this package can resume a C-Hercules run (the inverse migration).
    Default layout is one PE (global node order); gnid_maps splits the
    state into per-PE slabs as an N-PE reference run would have."""
    u_now = np.asarray(u_now, np.float64)
    u_prev = np.asarray(u_prev, np.float64)
    if u_now.ndim != 2 or u_now.shape[1] != 3:
        # [3, X] states from the brick/packed paths are in brick
        # concat order (padded, plan.gnid_cat indexing), NOT global
        # node order; transposing one here would silently scramble
        # the exported field.  Callers must de-layout first.
        raise ValueError(
            "write_reference_checkpoint needs canonical global [N,3] "
            f"fields (got {u_now.shape}); brick-layout states must be "
            "mapped back to global node order first")
    if gnid_maps is None:
        gnid_maps = [np.arange(len(u_now), dtype=np.int64)]
    gs = len(gnid_maps)
    nmax = max(len(m) for m in gnid_maps)
    ft = "<f4" if single_precision else "<f8"
    w = 4 if single_precision else 8
    with open(path, "wb") as f:
        np.array([gs, step, nmax], "<i4").tofile(f)
        for pe, m in enumerate(gnid_maps):
            f.seek(12 + 2 * pe * nmax * 3 * w)
            np.stack([u_prev[m], u_now[m]]).astype(ft).tofile(f)
        # pad to the full fixed stride so round trips are symmetric
        # even when the last PE harbors < nharboredmax nodes (the
        # reference reader seeks within this stride)
        f.truncate(12 + 2 * gs * nmax * 3 * w)
    return path


def _flatten(tree):
    """Tiny pytree flatten for tuples/lists of arrays."""
    flat = []

    def rec(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                rec(y)
        elif x is not None:
            flat.append(x)

    rec(tree)
    return flat, None
