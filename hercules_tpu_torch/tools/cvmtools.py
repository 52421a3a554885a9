"""CVM database CLI tools (quake/cvm/{querycvm,scancvm,dumpcvm,
showdbctl,pickrecord}.c):

  python -m hercules_tpu_torch.tools.cvmtools querycvm <db.e> [east north depth]
  python -m hercules_tpu_torch.tools.cvmtools scancvm <db.e>
  python -m hercules_tpu_torch.tools.cvmtools dumpcvm <db.e> [limit]
  python -m hercules_tpu_torch.tools.cvmtools showdbctl <db.e>
  python -m hercules_tpu_torch.tools.cvmtools pickrecord <db.e> <index>
  python -m hercules_tpu_torch.tools.cvmtools flatten <db.e> <out.flat> \
      <domain_x_m> <domain_y_m> <domain_z_m>

The port's copy of ``hercules_tpu/tools/cvmtools.py``, on the port's own
host modules: its output equals the JAX tool's on the same files
(tests/test_torch_tools.py).
"""

from __future__ import annotations

import sys

import numpy as np

from ..cvm import CVM
from ..etree import morton


def querycvm(db, args, out=None):
    out = out or sys.stdout
    cvm = CVM(db)

    def one(east, north, depth):
        ok, vp, vs, rho = cvm.query([east], [north], [depth])
        if not ok[0]:
            out.write("Cannot find the query point\n")
        else:
            out.write(f"\nVp = {vp[0]:.4f}\nVs = {vs[0]:.4f}\n"
                      f"density = {rho[0]:.4f}\n\n")

    if len(args) >= 3:
        one(float(args[0]), float(args[1]), float(args[2]))
        return 0
    for line in sys.stdin:
        toks = line.split()
        if len(toks) < 3:
            break
        one(float(toks[0]), float(toks[1]), float(toks[2]))
    return 0


def scancvm(db, out=None):
    out = out or sys.stdout
    """Scan for extreme material values (scancvm.c:97)."""
    cvm = CVM(db)
    names = cvm.db.schema.names
    pl = cvm.db.payload
    vp = pl[names[0]].astype(np.float64)
    vs = pl[names[1]].astype(np.float64)
    rho = pl[names[2]].astype(np.float64)
    out.write(f"records          = {cvm.db.n}\n")
    out.write(f"min Vp = {vp.min():.4f}  max Vp = {vp.max():.4f}\n")
    out.write(f"min Vs = {vs.min():.4f}  max Vs = {vs.max():.4f}\n")
    out.write(f"min rho = {rho.min():.4f}  max rho = {rho.max():.4f}\n")
    return 0


def dumpcvm(db, limit=None, out=None):
    out = out or sys.stdout
    cvm = CVM(db)
    x, y, z, lv, pl = cvm.db.octants()
    names = cvm.db.schema.names
    n = cvm.db.n if limit is None else min(int(limit), cvm.db.n)
    ts = cvm.ticksize
    for i in range(n):
        out.write(f"({x[i]} {y[i]} {z[i]} {lv[i]})L "
                  f"{x[i]*ts:.2f}m {y[i]*ts:.2f}m {z[i]*ts:.2f}m  ")
        out.write(" ".join(f"{names[j]}={pl[i][names[j]]:.2f}"
                           for j in range(3)))
        out.write("\n")
    return 0


def showdbctl(db, out=None):
    out = out or sys.stdout
    cvm = CVM(db)
    c = cvm.ctl
    for k in ("create_model_name", "create_author", "create_date",
              "create_field_count", "create_field_names",
              "region_origin_latitude_deg", "region_origin_longitude_deg",
              "region_length_east_m", "region_length_north_m",
              "region_depth_shallow_m", "region_depth_deep_m",
              "domain_endpoint_x", "domain_endpoint_y",
              "domain_endpoint_z"):
        out.write(f"{k:28s} = {getattr(c, k)}\n")
    out.write(f"{'ticksize':28s} = {cvm.ticksize}\n")
    return 0


def pickrecord(db, index, out=None):
    out = out or sys.stdout
    cvm = CVM(db)
    i = int(index)
    if not 0 <= i < cvm.db.n:
        out.write(f"record {i} out of range [0, {cvm.db.n})\n")
        return 1
    x, y, z, lv, pl = cvm.db.octants()
    names = cvm.db.schema.names
    out.write(f"addr = ({x[i]} {y[i]} {z[i]}) level {lv[i]}\n")
    for j in range(3):
        out.write(f"{names[j]} = {pl[i][names[j]]}\n")
    return 0


def flatten(db_path, out_path, domain_x_m, domain_y_m, domain_z_m,
            out=None):
    """Convert an etree CVM into the flat-record file the reference's
    non-USECVMDB build consumes (FlatCVM.RECORD layout): one record per
    leaf octant at its lower corner, emitted in Z order.  For a query
    point inside a leaf, the Z-order floor record is exactly that
    leaf's corner record, so the flat file answers every in-domain
    query identically to the etree (zsearch, psolve.c:1402-1437 vs
    etree_search's ancestor-floor lookup, etree.c:563-615).

    The etree stores coordinates at its own resolution
    (ctl.domain_endpoint ticks over region_length); the flat file's
    address space is the RUN's octor tick grid << 1, so corners are
    rescaled through meters using the run domain extents."""
    from ..cvm import FlatCVM
    from ..mesh.octree import domain_ticks

    out = out or sys.stdout
    cvm = CVM(db_path)
    db = cvm.db
    if db.out_of_core:
        raise ValueError("flatten: open the source in-memory "
                         "(unset HT_ETREE_MMAP)")
    farendp, ts = domain_ticks(domain_x_m, domain_y_m, domain_z_m)
    ex, ey, ez = morton.deinterleave3(db.hi, db.lo)
    rec = np.empty(db.n, FlatCVM.RECORD)
    # etree coords -> meters (one ticksize for all axes, CVM.query's
    # convention) -> run octor ticks -> etree address space
    cts = cvm.ticksize
    for name, v, far in (("x", ex, farendp[0]), ("y", ey, farendp[1]),
                         ("z", ez, farendp[2])):
        m = v.astype(np.float64) * cts
        # round-half-even, not truncation: when cts/ts is not an exact
        # binary ratio, float rounding in m/ts can land epsilon below
        # the true integer corner and a truncating cast would shift the
        # record key one tick low (mis-flooring queries just below it)
        t = np.minimum(np.rint(m / ts).astype(np.int64), far - 1)
        rec[name] = (t << 1).astype(np.int32)
    fields = db.schema.names
    rec["Vp"] = db.payload[fields[0]]
    rec["Vs"] = db.payload[fields[1]]
    rec["rho"] = db.payload[fields[2]]
    order = np.lexsort((db.lo, db.hi))
    rec[order].tofile(out_path)
    print(f"{out_path}: {db.n} records", file=out)
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(__doc__)
        return 2
    cmd, db = argv[0], argv[1]
    if cmd == "querycvm":
        return querycvm(db, argv[2:])
    if cmd == "scancvm":
        return scancvm(db)
    if cmd == "dumpcvm":
        return dumpcvm(db, argv[2] if len(argv) > 2 else None)
    if cmd == "showdbctl":
        return showdbctl(db)
    if cmd == "pickrecord":
        return pickrecord(db, argv[2])
    if cmd == "flatten":
        return flatten(db, argv[2], float(argv[3]), float(argv[4]),
                       float(argv[5]))
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
