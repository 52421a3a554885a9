"""qmesh: standalone mesh-generator run producing mesh.e without
solving (qmesh.c:24-33,718).

  python -m hercules_tpu_torch.tools.qmesh <cvmdb> <physics.in> <numerical.in> \
      <mesh.e> [--matlab <dir>]

The port's copy of ``hercules_tpu/tools/qmesh.py``, on the port's own
host modules: its output equals the JAX tool's on the same files
(tests/test_torch_tools.py).
"""

from __future__ import annotations

import sys
import time


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 4:
        print(__doc__)
        return 2
    cvmdb, physics_in, numerical_in, mesh_out = argv[:4]
    matlab_dir = None
    if "--matlab" in argv:
        matlab_dir = argv[argv.index("--matlab") + 1]

    from ..config import load_params
    from ..cvm import CVM
    from ..meshgen import generate_mesh
    from ..io.meshout import write_mesh_etree

    params = load_params(physics_in, numerical_in)
    cvm = CVM(cvmdb)
    t0 = time.time()
    mesh = generate_mesh(params, cvm, verbose=True)
    print(f"mesh_generate: {time.time()-t0:.1f}s, {mesh.lenum} elements, "
          f"{mesh.nnum} nodes, {len(mesh.dn_ids)} dangling")
    n = write_mesh_etree(mesh_out, mesh)
    print(f"mesh etree written: {mesh_out} ({n} records)")
    if matlab_dir:
        from ..io.matlab import write_matlab_mesh
        bbox = None
        if params.mesh_corners_matlab is not None:
            c = params.mesh_corners_matlab
            bbox = (c[0], c[2], c[1], c[3], c[4], c[5])
        write_matlab_mesh(matlab_dir, mesh, params, bbox=bbox)
        print(f"matlab mesh coordinates written: {matlab_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
