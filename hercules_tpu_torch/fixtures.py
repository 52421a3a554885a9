"""The in-repo box case: a homogeneous 1000 x 1000 x 500 m block with a
point source and surface/buried stations, written as a run directory
the CLI and ``Simulation.setup`` read unmodified.

Material Vp 6000, Vs 3464, rho 2700 m/s / kg/m^3 (the reference's
``examples/simple`` box), Rayleigh damping, a cartesian point source at
the box centre.  The element edge is chosen through the maximum
frequency, ``freq = Vs / (8 * edge)``; the time step is
``0.4 * edge / Vp``.  At edge 62.5 m the mesh is one 16 x 16 x 8 brick
(2048 elements, 2601 nodes); at 7.8125 m it is 128 x 128 x 64 = 2^20
elements.

``damping``, ``layers``, ``freq`` and ``use_infinite_qk`` vary the
case: the BKT fixtures are the box with ``damping="bkt"`` (one Q set,
shear attenuation only), ``SOFT_LAYERS`` at ``SOFT_FREQ`` (one Q set
with the bulk attenuation on) and ``TWO_LAYERS`` at ``SOFT_FREQ`` (two
Q sets: one brick, not uniform in Q).  All three mesh to the 62.5 m
brick.  ``FOUR_Q_LAYERS`` at ``four_q_freq(edge_m)`` is a slow
four-layer box whose Vs values fall in four Q bins (Q about 38, 51, 65
and 84): one brick at 62.5 m (2048 elements) and at 7.8125 m (2^20
elements).  ``THIN_Q_LAYERS`` at ``four_q_freq(edge_m)`` cycles
through the same four materials in 32 layers of 15.625 m: 31
interfaces, so at 7.8125 m (2^20 elements, one brick) about 48 % of
the elements are mixed and the tier rule picks the corner tier (K4); at
15.625 m every element plane is its own layer.  The CVM is written at
62.5 m, or at the thinnest layer's thickness where that is less.
``use_infinite_qk=True`` turns the bulk attenuation off (shear-only
BKT) on any layer table.

The graded fixtures (at ``freq=four_q_freq(edge_m)``) are multi-brick
plans.  ``GRADED_LAYERS`` (Vs 600, 1500 and 2900 m/s from 0, 125 and
250 m: each more than doubles the one above) meshes at edge_m down to
125 m and coarsens 2:1 there and again at 250 m:

    edge_m   elements   nodes      dangling  bricks (nodes each)        loose
    62.5     592        973        264       867, 162, 50               0
    15.625   37,888     43,537     3,936     5,445, 38,025              1,024
    7.8125   303,104    325,409    15,552    9,801, 38,025, 282,897     0
    3.90625  2,424,832  2,513,473  61,824    71,825, 282,897, 2,179,617 0

The plans without loose elements take the plane reconciler, the
15.625 m plan the index epilogue; at 3.90625 m the fine brick's node
plane (257 x 257) exceeds the JAX package's tile, so every brick stores
its axes reordered, (1, 2, 0).  With BKT the three materials have no
bulk attenuation and each brick one Q set: the uniform tier (K2).
``GRADED_Q_LAYERS`` and ``GRADED_THIN_LAYERS`` run the top 125 m
through FOUR_Q_LAYERS' four materials (four Q sets, all meshed at the
top edge) in 31.25 m and in 15.625 m layers; their meshes equal
GRADED_LAYERS'.  Their fine brick's BKT tier by the rule: at 7.8125 m
the node tier (K3) for GRADED_Q_LAYERS (3 of its 16 element planes
mixed, 18.75 %) and the corner tier (K4) for GRADED_THIN_LAYERS (7 of
16, 43.75 %); at 15.625 m the corner tier for both; at 62.5 m the
corner tier for GRADED_Q_LAYERS and the uniform one for
GRADED_THIN_LAYERS (both element centres of its 2 planes fall in one
material).  ``terashake_case`` copies the committed TeraShake run
directory (``examples/terashake/run/``; 600 x 300 x 84.4 km, a
``planewithkinks`` source, Rayleigh damping, no stations, 200 steps):
25,600 elements, 1 brick and 9,216 loose elements, 9,408 dangling
nodes, the index epilogue.

The keys of nonlinear soil, DRM and buildings are appended to a
case's numerical.in by ``add_nonlinear_keys``, ``add_drm_keys`` and
``add_building_keys`` (the JAX package's own test blocks:
tests/test_drm.py:19-29, tests/test_buildings.py:15-24).
``NL_LAYERS`` at ``NL_FREQ`` is the box with a soft 250 m layer (Vs
1500 m/s, two bricks), the JAX package's mixed nonlinear mesh.
``hypocenter`` moves the point source (the DRM cases put it outside
the DRM box) and ``dt`` sets the time step (the carved building box
needs ``BUILDING_DT``).

Layout written under ``root``::

    box.e              CVM etree (62.5 m octants)
    in/physics.in
    in/numerical.in
    in/src/source.in
"""

from __future__ import annotations

import os
import re
import shutil

from .tools.makecvm import build_layered_cvm

VP, VS, RHO = 6000.0, 3464.0, 2700.0
# CVM layer tables: rows (top depth m, Vp, Vs, rho)
LAYERS = ((0.0, VP, VS, RHO),)
SOFT_LAYERS = ((0.0, 2400.0, 1200.0, 2350.0),)
TWO_LAYERS = ((0.0, 2400.0, 1200.0, 2350.0),
              (250.0, 3600.0, 2000.0, 2500.0))
# maximum frequency of the soft fixtures: 8 nodes per wavelength at
# Vs 1200 m/s need 62.5 m elements
SOFT_FREQ = 2.4
# four layers, Vs 600-1100 m/s: all under 2 Vs_min, so the mesh stays
# one brick; the Qs(Vs) fit puts each in its own QTABLE bin
FOUR_Q_LAYERS = ((0.0, 1200.0, 600.0, 2000.0),
                 (125.0, 1500.0, 750.0, 2100.0),
                 (250.0, 1800.0, 900.0, 2200.0),
                 (375.0, 2200.0, 1100.0, 2300.0))
# 32 layers of 15.625 m through FOUR_Q_LAYERS' materials, top down
THIN_Q_LAYERS = tuple((15.625 * i, *FOUR_Q_LAYERS[i % 4][1:])
                      for i in range(32))
# three layers whose Vs more than doubles at 125 m and again at 250 m:
# at four_q_freq(edge) the mesh coarsens 2:1 at each (a graded plan)
GRADED_LAYERS = ((0.0, 1200.0, 600.0, 2000.0),
                 (125.0, 3000.0, 1500.0, 2400.0),
                 (250.0, 5000.0, 2900.0, 2600.0))
# GRADED_LAYERS with its top 125 m through FOUR_Q_LAYERS' four
# materials (all meshed at the top edge): in 31.25 m layers, and in
# 15.625 m layers (twice through the four)
GRADED_Q_LAYERS = tuple((31.25 * i, *FOUR_Q_LAYERS[i][1:])
                        for i in range(4)) + GRADED_LAYERS[1:]
GRADED_THIN_LAYERS = tuple((15.625 * i, *FOUR_Q_LAYERS[i % 4][1:])
                           for i in range(8)) + GRADED_LAYERS[1:]
EAST_M, NORTH_M, DEPTH_M = 1000.0, 1000.0, 500.0
# the CVM's octant edge, unless a layer is thinner
CVM_RES_M = 62.5
# surface corners (lon, lat) of a bilinear map with 1e-5 degrees per
# metre: a station at (x_north, y_east) m sits at lat = x/1e5, lon = y/1e5
CORNERS = ((0.0, 0.0), (0.0, 0.01), (0.01, 0.01), (0.01, 0.0))
# station positions (x_north m, y_east m, depth m), off the node grid
STATIONS = ((263.0, 241.0, 0.0), (731.0, 512.0, 37.0),
            (498.0, 777.0, 0.0), (305.0, 690.0, 110.0),
            (612.0, 388.0, 250.0))


def box_freq(edge_m):
    """Maximum frequency whose 8-points-per-wavelength edge is edge_m."""
    return VS / (8.0 * edge_m)


def four_q_freq(edge_m):
    """Maximum frequency of the four-layer box meshed at edge_m: 8
    nodes per wavelength at its slowest Vs (600 m/s)."""
    return 600.0 / (8.0 * edge_m)


def box_dt(edge_m):
    return 0.4 * edge_m / VP


def _corners_text():
    return "".join(f" {lon:.6f} {lat:.6f}\n" for lon, lat in CORNERS)


def write_box_case(root, edge_m=62.5, steps=200, n_stations=2,
                   damping="rayleigh", layers=None, freq=None,
                   use_infinite_qk=False, hypocenter=None, dt=None):
    """Write the box case into ``root``; returns the paths
    (cvmdb, physics_in, numerical_in).  ``damping`` is the
    type_of_damping written; ``layers`` the CVM layer table (default
    ``LAYERS``); ``freq`` the maximum frequency (default
    ``box_freq(edge_m)``); ``use_infinite_qk`` writes that key (the
    bulk attenuation off) into numerical.in; ``hypocenter`` the source's
    (x north, y east, depth) m (default the box centre); ``dt`` the time
    step (default ``box_dt(edge_m)``)."""
    hx, hy, hz = hypocenter or (NORTH_M / 2, EAST_M / 2, DEPTH_M / 2)
    if not 0 <= n_stations <= len(STATIONS):
        raise ValueError(f"n_stations must be in [0, {len(STATIONS)}]")
    src_dir = os.path.join(root, "in", "src")
    os.makedirs(src_dir, exist_ok=True)
    cvmdb = os.path.join(root, "box.e")
    table = [list(r) for r in (layers or LAYERS)]
    tops = [r[0] for r in table] + [DEPTH_M]
    res = min([CVM_RES_M] + [b - a for a, b in zip(tops, tops[1:])])
    build_layered_cvm(cvmdb, EAST_M, NORTH_M, DEPTH_M, res, table)
    dt = box_dt(edge_m) if dt is None else dt
    physics = os.path.join(root, "in", "physics.in")
    with open(physics, "w") as f:
        f.write(f"region_origin_latitude_deg  = 0\n"
                f"region_origin_longitude_deg = 0\n"
                f"region_depth_shallow_m      = 0\n"
                f"region_length_east_m        = {EAST_M:g}\n"
                f"region_length_north_m       = {NORTH_M:g}\n"
                f"region_depth_deep_m         = {DEPTH_M:g}\n"
                f"region_azimuth_leftface_deg = 0\n"
                f"type_of_damping             = {damping}\n"
                f"source_directory            = in/src\n")
    stations = "".join(f" {x / 1e5:.8f} {y / 1e5:.8f} {z:g}\n"
                       for x, y, z in STATIONS[:n_stations])
    numerical = os.path.join(root, "in", "numerical.in")
    with open(numerical, "w") as f:
        f.write(f"simulation_wave_max_freq_hz    = "
                f"{box_freq(edge_m) if freq is None else freq!r}\n"
                f"simulation_node_per_wavelength = 8\n"
                f"simulation_shear_velocity_min  = 500\n"
                f"simulation_start_time_sec      = 0\n"
                # half a step past the last one: total_steps is the
                # truncated quotient end/dt
                f"simulation_end_time_sec        = {(steps + 0.5) * dt!r}\n"
                f"simulation_delta_time_sec      = {dt!r}\n"
                f"the_threshold_damping          = 0.05\n"
                f"the_threshold_Vp_over_Vs       = 3\n"
                f"monitor_file                   = monitor.txt\n"
                f"number_output_stations         = {n_stations}\n"
                f"output_stations_print_rate     = 1\n"
                f"output_stations_directory      = stations\n"
                f"output_stations =\n{stations}\n"
                f"domain_surface_corners =\n{_corners_text()}\n")
        if use_infinite_qk:
            f.write("use_infinite_qk                = 1\n")
    with open(os.path.join(src_dir, "source.in"), "w") as f:
        f.write(f"source_is_filtered   = 0\n"
                f"type_of_source       = point\n"
                f"source_function_type = ramp\n"
                f"average_risetime_sec = 0.1\n"
                f"lonlat_or_cartesian  = 1\n"
                f"hypocenter_x         = {hx:g}\n"
                f"hypocenter_y         = {hy:g}\n"
                f"hypocenter_depth_m   = {hz:g}\n"
                f"moment_magnitude     = 4.0\n"
                f"source_strike_deg    = 30\n"
                f"source_dip_deg       = 60\n"
                f"source_rake_deg      = 90\n"
                f"domain_surface_corners =\n{_corners_text()}\n")
    return cvmdb, physics, numerical


# one output plane over the box's surface: (lat, lon, depth, strike step
# m, points along strike, dip step m, points down dip, strike, dip) --
# 17 x 17 points 50 m apart from (100, 100) m north and east
SURFACE_PLANE = (0.001, 0.001, 0.0, 50.0, 17, 50.0, 17, 0.0, 0.0)


def add_output_keys(physics_in, numerical_in, output_rate=None,
                    planes_rate=None, checkpointing_rate=None):
    """Turn on a case's outputs, each whose rate is given: 4-D
    displacement and velocity (``disp.h4d``, ``vel.h4d``) every
    ``output_rate`` steps, SURFACE_PLANE (``planes/``) every
    ``planes_rate``, checkpoints (``checkpoints/``, use_checkpoint = 1:
    a ``checkpoint.in`` there resumes the run) every
    ``checkpointing_rate``."""
    if output_rate:
        with open(physics_in, "a") as f:
            f.write("output_displacement = yes\n"
                    "output_velocity = yes\n"
                    "output_displacement_file = disp.h4d\n"
                    "output_velocity_file = vel.h4d\n")
    with open(numerical_in, "a") as f:
        if output_rate:
            f.write(f"simulation_output_rate = {output_rate}\n")
        if planes_rate:
            f.write(f"number_output_planes = 1\n"
                    f"output_planes_print_rate = {planes_rate}\n"
                    f"output_planes_directory = planes\n"
                    f"output_planes =\n"
                    f" {' '.join(f'{v:g}' for v in SURFACE_PLANE)}\n")
        if checkpointing_rate:
            f.write(f"use_checkpoint = 1\n"
                    f"checkpointing_rate = {checkpointing_rate}\n"
                    f"checkpoint_path = checkpoints\n")


# fixture (a) with a soft layer over the stiff halfspace (Vs 1500 m/s
# to 250 m, the box's material below), at NL_FREQ: the vs-rule meshes
# the layer at 62.5 m and the halfspace at 125 m (2 bricks), and a
# nonlinear Vs cut of 2000 m/s selects the layer's elements
NL_LAYERS = ((0.0, 3000.0, 1500.0, 2300.0), (250.0, VP, VS, RHO))
NL_FREQ = 2.0
# one row of material_properties_list: Vs limit, alpha (or cohesion),
# k (or friction angle), strain rate, sensitivity, hardening
NL_PROPERTIES = ((0.0, 0.0, 1e3, 1e-3, 1.0, 0.0),
                 (1e10, 0.0, 1e3, 1e-3, 1.0, 0.0))


def add_nonlinear_keys(numerical_in, vs_cut, model="vonMises",
                       plasticity="rate_independant",
                       properties_type="alphakay",
                       properties=NL_PROPERTIES, geostatic_s=0.0,
                       cushion_s=0.0):
    """Turn on nonlinear soil (include_nonlinear_analysis) in a case's
    numerical.in: elements with Vs at most ``vs_cut`` m/s, the material
    model and plasticity type, the property table (rows of
    NL_PROPERTIES' columns) and, where ``geostatic_s`` > 0, geostatic
    loading over that many seconds plus ``cushion_s``."""
    rows = "".join(" " + " ".join(f"{v!r}" for v in r) + "\n"
                   for r in properties)
    with open(numerical_in, "a") as f:
        f.write(f"include_nonlinear_analysis = yes\n"
                f"nonlinear_shear_velocity_cut = {vs_cut!r}\n"
                f"material_model = {model}\n"
                f"material_properties_type = {properties_type}\n"
                f"material_plasticity_type = {plasticity}\n"
                f"material_properties_count = {len(properties)}\n"
                f"material_properties_list =\n{rows}"
                f"geostatic_loading_time_sec = {geostatic_s!r}\n"
                f"geostatic_cushion_time_sec = {cushion_s!r}\n")


# the DRM box of the JAX package's DRM tests: (xmin, ymin, xmax, ymax,
# depth) m, inside the 1000 x 1000 x 500 m box; and a shallow one whose
# DRM elements lie in the top 125 m of the graded layer sets, where the
# mesh is uniform at 7.8125 m (a DRM element on a coarsening interface,
# with dangling corners, breaks the method's exactness), with a source
# 50 m from its x face
DRM_BOX = (250.0, 250.0, 750.0, 750.0, 250.0)
DRM_SHALLOW_BOX = (250.0, 250.0, 750.0, 750.0, 62.5)
DRM_HYPOCENTER = (200.0, 500.0, 30.0)


def add_drm_keys(numerical_in, directory, part, part1_dt, box=DRM_BOX,
                 edgesize=62.5, print_rate=1, offset=(0.0, 0.0)):
    """Turn on the domain reduction method (implement_drm) in a case's
    numerical.in: ``part`` "part0", "part1" or "part2", its files in
    ``directory``, the DRM box, part 1's time step ``part1_dt`` and
    record rate ``print_rate``."""
    with open(numerical_in, "a") as f:
        f.write(f"implement_drm = yes\n"
                f"drm_directory = {directory}\n"
                f"which_drm_part = {part}\n"
                f"drm_edgesize = {edgesize!r}\n"
                f"drm_offset_x = {offset[0]!r}\n"
                f"drm_offset_y = {offset[1]!r}\n"
                f"drm_print_rate = {print_rate}\n"
                f"part1_delta_t = {part1_dt!r}\n"
                f"drm_boundary =\n {' '.join(f'{v!r}' for v in box)}\n")


# the building of the JAX package's building tests: xmin xmax ymin ymax
# depth height m, then the building's and the foundation's Vp, Vs, rho
BUILDING = (437.5, 562.5, 437.5, 562.5, 62.5, 62.5,
            1000.0, 500.0, 2000.0, 2000.0, 1000.0, 2200.0)
# the fixed-base signal: 60 samples 10 ms apart of (sin t, 0, 0) m
BASE_SIGNAL_DT = 0.01
# a time step under the carved box's stability bound (1.38 ms: the
# building's 7.8125 m elements)
BUILDING_DT = 0.001


def add_building_keys(root, numerical_in, fixed_base=False):
    """Turn on buildings (include_buildings) in a case's numerical.in:
    BUILDING above a free surface shifted down 62.5 m, carved from the
    mesh; with ``fixed_base``, its base nodes driven by the signal
    written to ``root``/fb/base.0."""
    import numpy as np
    with open(numerical_in, "a") as f:
        f.write(f"include_buildings = yes\n"
                f"number_of_buildings = 1\n"
                f"buildings_n_factor = 2\n"
                f"min_octant_size_m = 62.5\n"
                f"surface_shift_m = 62.5\n"
                f"consider_fixed_base = {'yes' if fixed_base else 'no'}\n"
                f"building_properties =\n"
                f" {' '.join(f'{v!r}' for v in BUILDING)}\n")
        if fixed_base:
            f.write(f"fixedbase_input_dt = {BASE_SIGNAL_DT!r}\n"
                    f"fixedbase_input_dir = fb\n"
                    f"fixedbase_input_startindex = 0\n"
                    f"fixedbase_input_sufix = base\n")
    if fixed_base:
        os.makedirs(os.path.join(root, "fb"), exist_ok=True)
        t = np.arange(60) * BASE_SIGNAL_DT
        np.savetxt(os.path.join(root, "fb", "base.0"),
                   np.stack([np.sin(t), 0 * t, 0 * t], 1))


# the basin case: a soft column (Vs 600 m/s) over the full depth for
# east < BASIN_EAST_M, Vs 1200 m/s elsewhere (rows Vp, Vs, rho)
BASIN_EAST_M = 250.0
BASIN_SOFT = (1200.0, 600.0, 2000.0)
BASIN_HARD = (2400.0, 1200.0, 2350.0)


def build_basin_cvm(path, res_m=CVM_RES_M):
    """Write the basin case's CVM etree (the box's domain, octants of
    edge res_m): BASIN_SOFT where an octant's centre lies east of the
    origin by less than BASIN_EAST_M, BASIN_HARD elsewhere, at every
    depth."""
    import numpy as np

    from .cvm import DBCtl
    from .etree.writer import EtreeWriter
    maxdim = max(EAST_M, NORTH_M, DEPTH_M)
    endpoint = 1 << 31
    ticksize = maxdim / endpoint
    level = int(np.ceil(np.log2(maxdim / res_m)))
    edge_ticks = endpoint >> level
    edge_m = edge_ticks * ticksize
    nx, ny, nz = (int(np.ceil(v / edge_m)) for v in (EAST_M, NORTH_M,
                                                      DEPTH_M))
    ii = np.arange(nx * ny * nz, dtype=np.int64)
    ix, iy, iz = ii % nx, (ii // nx) % ny, ii // (nx * ny)
    soft = (ix + 0.5) * edge_m < BASIN_EAST_M
    mat = np.where(soft[:, None], np.asarray(BASIN_SOFT, "<f4"),
                   np.asarray(BASIN_HARD, "<f4")).astype("<f4")
    ctl = DBCtl(
        create_model_name="Title:BASIN", create_author="Author:HT",
        create_date="Date:01/01/2026", create_field_count="3",
        create_field_names="Vp(float);Vs(float);density(float)",
        region_origin_latitude_deg=0.0, region_origin_longitude_deg=0.0,
        region_length_east_m=EAST_M, region_length_north_m=NORTH_M,
        region_depth_shallow_m=0.0, region_depth_deep_m=DEPTH_M,
        domain_endpoint_x=int(round(EAST_M / ticksize)),
        domain_endpoint_y=int(round(NORTH_M / ticksize)),
        domain_endpoint_z=int(round(DEPTH_M / ticksize)))
    w = EtreeWriter(path, 12, appmeta=ctl.to_text(),
                    asciischema="L 3 Vp float 4 0 Vs float 4 4 "
                                "density float 4 8 ")
    t = lambda i: (i * edge_ticks).astype(np.uint32)
    return w.write(t(ix), t(iy), t(iz), np.full(len(ii), level, np.uint8),
                   np.ascontiguousarray(mat).view(np.uint8).reshape(-1, 12))


def write_basin_case(root, edge_m=62.5, steps=200, n_stations=2,
                     damping="rayleigh", hypocenter=None):
    """The box case over the basin CVM (build_basin_cvm) at
    freq = four_q_freq(edge_m): the soft column meshes at edge_m and the
    rest one level coarser, a laterally graded plan whose interface is
    a vertical plane (gslab refuses it, gmesh takes it).  At 3.90625 m
    the column is 64 x 256 x 128 = 2,097,152 elements and the rest 96 x
    128 x 64 = 786,432 (2,883,584).  Returns write_box_case's paths."""
    paths = write_box_case(root, edge_m, steps, n_stations, damping=damping,
                           freq=four_q_freq(edge_m), hypocenter=hypocenter)
    build_basin_cvm(paths[0])
    return paths


def box_simulation(root, edge_m=62.5, steps=200, n_stations=2, **case):
    """Write the box case into ``root`` and set it up: the port's
    ``Simulation`` (mesh, tables, source forces, stations).  ``case``:
    write_box_case's damping, layers, freq and use_infinite_qk."""
    from .sim import Simulation
    cvmdb, physics, numerical = write_box_case(root, edge_m, steps,
                                               n_stations, **case)
    return Simulation.setup(physics, numerical, cvmdb=cvmdb)


# the committed TeraShake run directory (examples/terashake/run)
TERASHAKE_RUN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "terashake", "run")


def _set_keys(path, subs):
    """Apply the (pattern, replacement) pairs ``subs`` to an input file,
    each pattern matching exactly once."""
    with open(path) as f:
        text = f.read()
    for pat, rep in subs:
        text, n = re.subn(pat, rep, text, flags=re.M)
        if n != 1:
            raise ValueError(f"{path}: {pat!r} matched {n} times")
    with open(path, "w") as f:
        f.write(text)


def terashake_case(root):
    """Copy ``examples/terashake/run/`` into ``root`` and make the copy
    run on the port; returns the paths (cvmdb, physics_in,
    numerical_in).  One time window in the source
    (``number_of_time_windows = 1``, ``time_windows = 0``): the
    committed slip.in and rake.in hold one window's 8 x 50 values,
    where source.in asks for six."""
    shutil.copytree(TERASHAKE_RUN, root, dirs_exist_ok=True)
    numerical = os.path.join(root, "in", "numerical.in")
    _set_keys(os.path.join(root, "in", "src", "source.in"),
              [(r"^(number_of_time_windows\s*=\s*)\S+", r"\g<1>1"),
               (r"^(time_windows\s*=\s*\n)[^\n]*", r"\g<1>0")])
    return (os.path.join(root, "tera_layers.e"),
            os.path.join(root, "in", "physics.in"), numerical)


def box_stats(edge_m):
    """(elements, nodes) of the box mesh at this edge."""
    nx, ny, nz = (int(round(v / edge_m)) for v in (NORTH_M, EAST_M,
                                                  DEPTH_M))
    return nx * ny * nz, (nx + 1) * (ny + 1) * (nz + 1)


def one_torch_thread():
    """An autouse, module-scoped pytest fixture that runs the module's
    torch work on one intra-op thread and restores the count after:
    ``_one_torch_thread = one_torch_thread()`` in a test module.  Its
    tensors are small, and under parallel test workers several threads
    per op run tens of times slower, not faster."""
    import pytest
    import torch

    @pytest.fixture(autouse=True, scope="module")
    def _one_torch_thread():
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)

    return _one_torch_thread


def loh1_case(root):
    """Write the LOH.1 benchmark (validation B2, ``tools/loh1.py``) as a
    run directory under ``root``: ``loh1.e`` (the layered CVM, 250 m
    octants) and the box case's input files with the LOH.1 region,
    time step, end time and source (``loh1.write_inputs``); returns the
    paths (cvmdb, physics_in, numerical_in).  The vs-rule meshes it at
    375 m in the layer and 750 m below, a graded mesh of 5,632
    elements, 7,179 nodes and 800 dangling nodes, 200 steps; no
    stations in the files (``loh1.simulation`` samples the benchmark's
    three)."""
    from .tools import loh1
    os.makedirs(root, exist_ok=True)
    loh1.build_cvm(root)
    physics, numerical = loh1.write_inputs(root)
    return os.path.join(root, "loh1.e"), physics, numerical
