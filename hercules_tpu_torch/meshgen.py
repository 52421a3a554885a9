"""mesh_generate: the full meshing pipeline (psolve.c:1921-2176).

newtree -> [progressive] refine -> balance -> (carve buildings) ->
extract -> correct properties.  Single global host pass; partitioning
for multi-chip runs happens afterwards (hercules_tpu.parallel).

The port's copy of ``hercules_tpu/meshgen.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

import numpy as np

from .config import Params
from .cvm import CVM
from .material import (MeshOrigin, correct_properties, make_setrec,
                       make_toexpand)
from .mesh import Octree, extract_mesh
from .mesh.extract import MeshArrays


def _cached_setrec(setrec, cache):
    """Wrap setrec with a (leaf-key, level) -> record cache from the
    previous progressive step: a leaf whose geometry is unchanged
    re-queries nothing (setrec is a pure function of (hi, lo, level)
    -- CVM samples at leaf-determined points).  Misses (children
    created since) fall through to the real setrec.  Results are
    bit-identical to uncached queries."""
    from .mesh.extract import _key128

    ck, clv, crec = cache

    def wrapped(tree_, hi, lo, lv):
        k = _key128(hi, lo)
        pos = np.minimum(np.searchsorted(ck, k), len(ck) - 1)
        hit = (ck[pos] == k) & (clv[pos] == lv)
        if not hit.any():
            return setrec(tree_, hi, lo, lv)
        miss = ~hit
        out = {}
        if miss.any():
            sub = setrec(tree_, hi[miss], lo[miss], lv[miss])
        else:
            sub = {name: v[:0] for name, v in crec.items()}
        for name, rows in crec.items():
            col = np.empty(len(lv), rows.dtype)
            col[hit] = rows[pos[hit]]
            if miss.any():
                col[miss] = sub[name]
            out[name] = col
        return out

    return wrapped


def generate_mesh(params: Params, cvm: CVM,
                  buildings=None, verbose=False) -> MeshArrays:
    from .utils.timers import GLOBAL_TIMERS as TM
    origin = MeshOrigin.from_params(params, cvm.ctl)
    with TM.span("Octor Newtree"):
        tree = Octree.newtree(params.region_length_north_m,
                              params.region_length_east_m,
                              params.region_depth_deep_m)

    setrec = make_setrec(cvm, params, origin, buildings=buildings)
    toexpand = make_toexpand(params, buildings=buildings)

    # progressive meshing (psolve.c:2002-2090): refine towards the target
    # frequency in factor-of-2 steps to keep 2:1 ripple local.
    # Across steps, (a) setrec results are cached per (leaf, level) --
    # a leaf that survived the previous step re-queries nothing (the
    # material record is a pure function of the leaf geometry), and
    # (b) the balance first-sweep probes only the leaves refine
    # actually split (sound: the tree enters each step balanced and
    # refine only splits, so every new 2:1 violation has a new child
    # as its source -- see Octree.balance).
    steps = max(0, int(params.step_meshing))
    rec = None
    cache = None       # (key128 sorted, levels, {name: rows})
    balanced_before = False
    for mstep_pow in range(steps, -1, -1):
        mstep = 1 << mstep_pow
        scale = 1.0 / mstep

        if mstep == 1:
            te = toexpand
        else:
            def te(tree_, hi, lo, lv, rec_, _s=scale):
                return rec_["edgesize"] > rec_["Vs"] / (params.factor * _s)

        from .mesh.extract import _key128
        sr = setrec if cache is None else _cached_setrec(setrec, cache)
        pre = None
        if balanced_before:
            # balanced + sorted leaf set entering this step
            pre = (_key128(tree.hi, tree.lo), tree.level.copy())
        with TM.span("Octor Refinetree"):
            rec = tree.refine(sr, te)
        if mstep > 1:
            # record aligned with the POST-refine sorted leaves (the
            # balance below splits some of them; their children miss
            # on the level check and re-query)
            cache = (_key128(tree.hi, tree.lo), tree.level.copy(),
                     rec)
        with TM.span("Octor Balancetree"):
            if pre is not None:
                # first-sweep sources = leaves refine created (a
                # surviving (key, level) pair is unchanged; child 0
                # shares its parent's anchor but not its level)
                k = _key128(tree.hi, tree.lo)
                pos = np.minimum(np.searchsorted(pre[0], k),
                                 len(pre[0]) - 1)
                new = ((pre[0][pos] != k)
                       | (pre[1][pos] != tree.level))
                tree.balance(frontier_keys=(tree.hi[new],
                                            tree.lo[new]))
            else:
                tree.balance()
        balanced_before = True
        if verbose:
            print(f"  meshing step x{mstep}: {tree.n} leaves")

    if buildings is not None:
        # octor_carvebuildings (octor.c:4817-4897): drop "air" leaves
        # (negative Vp) above the pushed-down surface
        with TM.span("Carve Buildings"):
            rec = setrec(tree, tree.hi, tree.lo, tree.level)
            tree.carve(buildings.carve_mask(rec))
        if verbose:
            print(f"  carved to {tree.n} leaves")

    with TM.span("Octor Extractmesh"):
        mesh = extract_mesh(tree)
    with TM.span("Mesh correct properties"):
        correct_properties(mesh, cvm, params, origin, buildings=buildings)
    mesh.origin = origin
    mesh.buildings = buildings
    return mesh
