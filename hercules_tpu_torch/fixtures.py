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
elements).  ``use_infinite_qk=True`` turns the bulk attenuation off
(shear-only BKT) on any layer table.

Layout written under ``root``::

    box.e              CVM etree (62.5 m octants)
    in/physics.in
    in/numerical.in
    in/src/source.in
"""

from __future__ import annotations

import os

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
EAST_M, NORTH_M, DEPTH_M = 1000.0, 1000.0, 500.0
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
                   use_infinite_qk=False):
    """Write the box case into ``root``; returns the paths
    (cvmdb, physics_in, numerical_in).  ``damping`` is the
    type_of_damping written; ``layers`` the CVM layer table (default
    ``LAYERS``); ``freq`` the maximum frequency (default
    ``box_freq(edge_m)``); ``use_infinite_qk`` writes that key (the
    bulk attenuation off) into numerical.in.  The time step stays
    ``box_dt(edge_m)``."""
    if not 0 <= n_stations <= len(STATIONS):
        raise ValueError(f"n_stations must be in [0, {len(STATIONS)}]")
    src_dir = os.path.join(root, "in", "src")
    os.makedirs(src_dir, exist_ok=True)
    cvmdb = os.path.join(root, "box.e")
    build_layered_cvm(cvmdb, EAST_M, NORTH_M, DEPTH_M, 62.5,
                      [list(r) for r in (layers or LAYERS)])
    dt = box_dt(edge_m)
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
                f"hypocenter_x         = {NORTH_M / 2:g}\n"
                f"hypocenter_y         = {EAST_M / 2:g}\n"
                f"hypocenter_depth_m   = {DEPTH_M / 2:g}\n"
                f"moment_magnitude     = 4.0\n"
                f"source_strike_deg    = 30\n"
                f"source_dip_deg       = 60\n"
                f"source_rake_deg      = 90\n"
                f"domain_surface_corners =\n{_corners_text()}\n")
    return cvmdb, physics, numerical


def box_simulation(root, edge_m=62.5, steps=200, n_stations=2, **case):
    """Write the box case into ``root`` and set it up: the port's
    ``Simulation`` (mesh, tables, source forces, stations).  ``case``:
    write_box_case's damping, layers, freq and use_infinite_qk."""
    from .sim import Simulation
    cvmdb, physics, numerical = write_box_case(root, edge_m, steps,
                                               n_stations, **case)
    return Simulation.setup(physics, numerical, cvmdb=cvmdb)


def box_stats(edge_m):
    """(elements, nodes) of the box mesh at this edge."""
    nx, ny, nz = (int(round(v / edge_m)) for v in (NORTH_M, EAST_M,
                                                  DEPTH_M))
    return nx * ny * nz, (nx + 1) * (ny + 1) * (nz + 1)

