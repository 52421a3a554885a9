"""Build CVM etree databases from layered velocity models.

The reference consumes CVM etrees built offline by the (not-in-tree)
SCEC tooling; this provides an in-tree equivalent for layered models:

  python -m hercules_tpu_torch.tools.makecvm out.e east_m north_m depth_m \
      res_m layers.txt [origin_lat origin_lon]

layers.txt rows: top_depth_m Vp Vs rho (layers from the surface down).

The port's copy of ``hercules_tpu/tools/makecvm.py``: the database it
writes is byte for byte the JAX package's (tests/test_torch_host.py).
"""

from __future__ import annotations

import sys

import numpy as np

from ..cvm import DBCtl
from ..etree.writer import EtreeWriter


def build_layered_cvm(path, east_m, north_m, depth_m, res_m, layers,
                      origin_lat=0.0, origin_lon=0.0,
                      model_name="Title:LAYERED", author="Author:HT",
                      date="Date:01/01/2026"):
    """Write a CVM etree with octants of edge ~res_m covering the
    domain, material from the layer table [n, 4] (top Vp Vs rho)."""
    layers = np.asarray(layers, np.float64)
    # etree domain: 2^31 ticks across the LARGEST extent.  (Spanning
    # the east extent like cvm.c would overflow the 32-bit record
    # coordinates whenever north > 2*east — elongated domains aliased
    # their keys modulo 2^32.)
    maxdim = max(east_m, north_m, depth_m)
    endpoint = 1 << 31
    ticksize = maxdim / endpoint
    # octant level whose edge is closest below res_m
    level = int(np.ceil(np.log2(maxdim / res_m)))
    edge_ticks = endpoint >> level
    edge_m = edge_ticks * ticksize

    nx = int(np.ceil(east_m / edge_m))
    ny = int(np.ceil(north_m / edge_m))
    nz = int(np.ceil(depth_m / edge_m))
    n = nx * ny * nz
    ii = np.arange(n, dtype=np.int64)
    ix = ii % nx
    iy = (ii // nx) % ny
    iz = ii // (nx * ny)
    x = (ix * edge_ticks).astype(np.uint32)
    y = (iy * edge_ticks).astype(np.uint32)
    z = (iz * edge_ticks).astype(np.uint32)

    zc = (iz + 0.5) * edge_m
    li = np.clip(np.searchsorted(layers[:, 0], zc, side="right") - 1,
                 0, len(layers) - 1)
    mat = layers[li, 1:4].astype("<f4")          # [n, 3] Vp Vs rho

    payload = np.zeros((n, 12), np.uint8)
    payload[:, :] = mat.view(np.uint8).reshape(n, 12)

    ctl = DBCtl(
        create_model_name=model_name, create_author=author,
        create_date=date, create_field_count="3",
        create_field_names="Vp(float);Vs(float);density(float)",
        region_origin_latitude_deg=origin_lat,
        region_origin_longitude_deg=origin_lon,
        region_length_east_m=east_m, region_length_north_m=north_m,
        region_depth_shallow_m=0.0, region_depth_deep_m=depth_m,
        domain_endpoint_x=int(round(east_m / ticksize)),
        domain_endpoint_y=int(round(north_m / ticksize)),
        domain_endpoint_z=int(round(depth_m / ticksize)),
    )
    w = EtreeWriter(path, 12, appmeta=ctl.to_text(),
                    asciischema="L 3 Vp float 4 0 Vs float 4 4 "
                                "density float 4 8 ")
    lv = np.full(n, level, np.uint8)
    return w.write(x, y, z, lv, payload)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 6:
        print(__doc__)
        return 2
    path, east, north, depth, res, layers_file = argv[:6]
    origin_lat = float(argv[6]) if len(argv) > 6 else 0.0
    origin_lon = float(argv[7]) if len(argv) > 7 else 0.0
    layers = np.loadtxt(layers_file).reshape(-1, 4)
    n = build_layered_cvm(path, float(east), float(north), float(depth),
                          float(res), layers, origin_lat, origin_lon)
    print(f"{path}: {n} octants written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
