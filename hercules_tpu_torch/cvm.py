"""CVM (community velocity model) material database.

Mirrors quake/cvm/cvm.c: an etree database whose app-metadata text string
("dbctl") carries the geographic origin/extent and whose leaf payloads are
(Vp, Vs, density) float32 records.  Queries are batch/vectorized
(cvm_query, cvm.c:265-316; dbctl parse, cvm.c:57-215).

The port's copy of ``hercules_tpu/cvm.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .etree.reader import EtreeReader

# meters per degree, cvm.h:32-33
DIST1LAT = 110922.0
DIST1LON = 92382.0


@dataclass
class DBCtl:
    create_model_name: str = ""
    create_author: str = ""
    create_date: str = ""
    create_field_count: str = ""
    create_field_names: str = ""
    region_origin_latitude_deg: float = 0.0
    region_origin_longitude_deg: float = 0.0
    region_length_east_m: float = 0.0
    region_length_north_m: float = 0.0
    region_depth_shallow_m: float = 0.0
    region_depth_deep_m: float = 0.0
    domain_endpoint_x: int = 0
    domain_endpoint_y: int = 0
    domain_endpoint_z: int = 0

    @classmethod
    def from_text(cls, text: str) -> "DBCtl":
        t = text.split()
        return cls(
            create_model_name=t[0], create_author=t[1], create_date=t[2],
            create_field_count=t[3], create_field_names=t[4],
            region_origin_latitude_deg=float(t[5]),
            region_origin_longitude_deg=float(t[6]),
            region_length_east_m=float(t[7]),
            region_length_north_m=float(t[8]),
            region_depth_shallow_m=float(t[9]),
            region_depth_deep_m=float(t[10]),
            domain_endpoint_x=int(t[11]),
            domain_endpoint_y=int(t[12]),
            domain_endpoint_z=int(t[13]),
        )

    def to_text(self) -> str:
        return (f"{self.create_model_name} {self.create_author} "
                f"{self.create_date} {self.create_field_count} "
                f"{self.create_field_names} "
                f"{self.region_origin_latitude_deg:f} "
                f"{self.region_origin_longitude_deg:f} "
                f"{self.region_length_east_m:f} "
                f"{self.region_length_north_m:f} "
                f"{self.region_depth_shallow_m:f} "
                f"{self.region_depth_deep_m:f} "
                f"{self.domain_endpoint_x} {self.domain_endpoint_y} "
                f"{self.domain_endpoint_z} ")


class FlatCVM:
    """sliceCVM-equivalent flat-record material model.

    The reference compiled without -DUSECVMDB reads the material from a
    plain record file instead of an etree (the `cvmdb_input_file` key
    doubles as its path, psolve.c:1129): a Z-order-sorted array of
    24-byte records

        int32 x, y, z     point in the ETREE address space
                          (= octor ticks << 1, psolve.c:1889-1891)
        float32 Vp, Vs, density

    distributed across ranks by contiguous Z-order slices
    (sliceCVM, psolve.c:1439-1671) and queried by a floor binary search
    in Z order (zsearch, psolve.c:1402-1437; setrec :1857-1913).  The
    TPU build meshes host-globally, so the "slice" is the whole array
    and a query is a batched floor search over the sorted Morton keys.

    Exposes the same interface as CVM (`query`, `ctl`, `ticksize`) so
    the one material pass (make_setrec / correct_properties) serves
    both database formats.  The flat file carries no geographic
    metadata; the domain geometry comes from the run parameters
    (the reference reads Param.theDomainX/Y/Z), so the synthesized
    dbctl pins the mesh origin offset to zero.
    """

    RECORD = np.dtype([("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
                       ("Vp", "<f4"), ("Vs", "<f4"), ("rho", "<f4")])

    def __init__(self, path: str, domain_x_m: float, domain_y_m: float,
                 domain_z_m: float, origin_lat: float = 0.0,
                 origin_lon: float = 0.0):
        from .etree import morton
        from .mesh.octree import domain_ticks

        rec = np.fromfile(path, dtype=self.RECORD)
        if len(rec) == 0:
            raise ValueError(f"{path}: empty flat CVM record file")
        # octor tick mapping of the run domain (x = south-north,
        # y = east-west, z = depth); record coords live at 2x this
        # resolution (etree address space)
        self.farendp, self.ticksize = domain_ticks(
            domain_x_m, domain_y_m, domain_z_m)
        hi, lo = morton.interleave3(rec["x"].astype(np.uint32),
                                    rec["y"].astype(np.uint32),
                                    rec["z"].astype(np.uint32))
        order = np.lexsort((lo, hi))
        # the reference requires the file pre-sorted (zsearch is a
        # plain binary search); sorting here costs one pass and makes
        # unsorted inputs correct instead of silently wrong
        self._hi, self._lo = hi[order], lo[order]
        self._vp = rec["Vp"][order].astype(np.float64)
        self._vs = rec["Vs"][order].astype(np.float64)
        self._rho = rec["rho"][order].astype(np.float64)
        self.ctl = DBCtl(
            create_model_name="flat", create_author="-", create_date="-",
            create_field_count="3", create_field_names="Vp,Vs,density",
            region_origin_latitude_deg=origin_lat,
            region_origin_longitude_deg=origin_lon,
            region_length_east_m=domain_y_m,
            region_length_north_m=domain_x_m,
            region_depth_shallow_m=0.0, region_depth_deep_m=domain_z_m,
            domain_endpoint_x=int(self.farendp[1]),
            domain_endpoint_y=int(self.farendp[0]),
            domain_endpoint_z=int(self.farendp[2]),
        )

    @classmethod
    def from_params(cls, path: str, params) -> "FlatCVM":
        return cls(path, params.region_length_north_m,
                   params.region_length_east_m,
                   params.region_depth_deep_m,
                   origin_lat=params.region_origin_latitude_deg,
                   origin_lon=params.region_origin_longitude_deg)

    def query(self, east_m, north_m, depth_m):
        """Vectorized flat-record query with the CVM.query contract:
        (ok, Vp, Vs, rho), NaN where out of the domain.  Coordinates
        quantize to octor ticks and shift into the etree address space
        exactly as the reference's setrec does (psolve.c:1875-1891);
        the hit is the Z-order floor record (zsearch semantics)."""
        from .etree import morton
        from .etree.reader import floor_indices

        east_m = np.atleast_1d(np.asarray(east_m, dtype=np.float64))
        north_m = np.atleast_1d(np.asarray(north_m, dtype=np.float64))
        depth_m = np.atleast_1d(np.asarray(depth_m, dtype=np.float64))
        ts = self.ticksize
        x = (north_m / ts).astype(np.int64)     # x = south-north
        y = (east_m / ts).astype(np.int64)
        z = (depth_m / ts).astype(np.int64)
        inb = ((north_m >= 0) & (east_m >= 0) & (depth_m >= 0)
               & (x < self.farendp[0]) & (y < self.farendp[1])
               & (z < self.farendp[2]))
        x, y, z = (np.clip(v, 0, f - 1)
                   for v, f in zip((x, y, z), self.farendp))
        q_hi, q_lo = morton.interleave3((x << 1).astype(np.uint32),
                                        (y << 1).astype(np.uint32),
                                        (z << 1).astype(np.uint32))
        idx = floor_indices(self._hi, self._lo, q_hi, q_lo)
        ok = inb & (idx >= 0)
        idx = np.maximum(idx, 0)
        nan = np.where(ok, 1.0, np.nan)
        return ok, self._vp[idx] * nan, self._vs[idx] * nan, \
            self._rho[idx] * nan


def open_material_db(path: str, params):
    """Open `cvmdb_input_file` as an etree CVM or, when the file is not
    an etree (the reference's non-USECVMDB build), as a flat record
    file (psolve.c:1064-1132 open_cvmdb's two compile-time paths,
    selected here by sniffing the format).

    Any 24-byte-multiple file "parses" as flat records, so the fallback
    is sanity-checked (finite, Vp >= Vs > 0, rho > 0, coords within the
    domain endpoints) before it is accepted — a corrupt or unsupported
    etree must be an error, not garbage material."""
    try:
        return CVM(path)
    except (ValueError, IndexError, OverflowError) as etree_err:
        try:
            flat = FlatCVM.from_params(path, params)
            _validate_flat(flat)
            return flat
        except (ValueError, IndexError, OverflowError) as flat_err:
            raise ValueError(
                f"{path}: not a usable material database. "
                f"As etree CVM: {etree_err}. "
                f"As flat records: {flat_err}.") from None


def _validate_flat(flat: "FlatCVM") -> None:
    """Reject a FlatCVM whose records cannot be physical material."""
    from .etree import morton

    vp, vs, rho = flat._vp, flat._vs, flat._rho
    if not (np.all(np.isfinite(vp)) and np.all(np.isfinite(vs))
            and np.all(np.isfinite(rho))):
        raise ValueError("non-finite Vp/Vs/rho records")
    if not (np.all(vs > 0) and np.all(vp >= vs) and np.all(rho > 0)):
        raise ValueError("records violate Vp >= Vs > 0, rho > 0")
    # record coords live in the etree address space = ticks << 1
    x, y, z = morton.deinterleave3(flat._hi, flat._lo)
    for c, f in zip((x, y, z), flat.farendp):
        if bool(np.any(c.astype(np.int64) >= (int(f) << 1))):
            raise ValueError("record coordinates outside the run domain")


class CVM:
    """Open a CVM etree and answer batched material queries."""

    def __init__(self, path: str):
        self.db = EtreeReader(path)
        if self.db.appmeta is None:
            raise ValueError(f"{path}: CVM database has no control data")
        self.ctl = DBCtl.from_text(self.db.appmeta)
        # cvm.c:291: ticksize from east extent / x endpoint
        self.ticksize = (self.ctl.region_length_east_m
                         / self.ctl.domain_endpoint_x)
        names = self.db.schema.names if self.db.schema else []
        # field names are Vp, Vs, density in reference DBs
        self._vp = names[0] if names else None

    def query(self, east_m, north_m, depth_m):
        """Vectorized cvm_query.  Inputs in meters (arrays broadcast).

        Returns (ok[n] bool, Vp[n], Vs[n], rho[n]) float64 arrays; failed
        queries hold NaN.
        """
        east_m = np.atleast_1d(np.asarray(east_m, dtype=np.float64))
        north_m = np.atleast_1d(np.asarray(north_m, dtype=np.float64))
        depth_m = np.atleast_1d(np.asarray(depth_m, dtype=np.float64))
        x = (east_m / self.ticksize).astype(np.int64)
        y = (north_m / self.ticksize).astype(np.int64)
        z = (depth_m / self.ticksize).astype(np.int64)
        inb = ((x >= 0) & (y >= 0) & (z >= 0)
               & (x < self.ctl.domain_endpoint_x)
               & (y < self.ctl.domain_endpoint_y)
               & (z < self.ctl.domain_endpoint_z))
        ok, idx = self.db.search_points(
            x.astype(np.uint32), y.astype(np.uint32), z.astype(np.uint32))
        ok = ok & inb
        nan = np.where(ok, 1.0, np.nan)
        cols = self._field_arrays()
        if cols is not None:
            vpa, vsa, rhoa = cols
            return ok, vpa[idx] * nan, vsa[idx] * nan, rhoa[idx] * nan
        rec = self.db.records(idx)
        fields = self.db.schema.names
        vp = rec[fields[0]].astype(np.float64) * nan
        vs = rec[fields[1]].astype(np.float64) * nan
        rho = rec[fields[2]].astype(np.float64) * nan
        return ok, vp, vs, rho

    def _field_arrays(self):
        """Cached float64 (Vp, Vs, rho) record columns — one structured
        decode for the whole DB instead of one per query batch (27
        query passes per meshing level make this the host-meshing hot
        path).  None for out-of-core readers (they keep the per-batch
        page decode)."""
        if not hasattr(self, "_cols"):
            if self.db.out_of_core:
                self._cols = None
            else:
                fields = self.db.schema.names
                pay = self.db.payload
                self._cols = tuple(pay[f].astype(np.float64)
                                   for f in fields[:3])
        return self._cols
