"""Hercules ``key = value`` config-file parser and simulation parameters.

Accepts the reference's input files unmodified (physics.in, numerical.in,
source.in).  Semantics mirror parsetext / parsedarray / read_config_string
(psolve.c:514-632, quake_util.c:171-208): a key matches a line whose first
token (split on " =\\n\\t") equals the key; the scalar value is the next
token; array/table values are whitespace-separated numbers following the
key line (reads continue across lines; '#' lines are comments).

The port's copy of ``hercules_tpu/config.py``, kept equal to it
(tests/test_torch_host.py).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class ConfigFile:
    """One parsed config file with parsetext-compatible lookups."""

    _DELIMS = re.compile(r"[ =\t]+")

    def __init__(self, path: str):
        self.path = path
        with open(path) as f:
            self.lines = f.read().splitlines()

    def _find(self, key: str):
        """Return (line_idx, tokens_after_key) for the first line whose
        first token == key, else None."""
        for i, line in enumerate(self.lines):
            toks = [t for t in self._DELIMS.split(line.strip()) if t]
            if toks and toks[0] == key:
                return i, toks[1:]
        return None

    def get(self, key, type=str, default=None, required=False):
        hit = self._find(key)
        if hit is None or not hit[1]:
            # value may be on following lines for array keys; scalar miss:
            if required:
                raise KeyError(f"{self.path}: missing config key {key!r}")
            return default
        val = hit[1][0]
        if type is str:
            return val
        try:
            return type(float(val)) if type in (int,) else type(val)
        except ValueError:
            if required:
                raise
            return default

    def get_double(self, key, default=None, required=False):
        v = self.get(key, float, default, required)
        return v

    def get_int(self, key, default=None, required=False):
        return self.get(key, int, default, required)

    def get_string(self, key, default=None, required=False):
        return self.get(key, str, default, required)

    def get_array(self, key, count=None):
        """parsedarray semantics: numbers following the key (the key line's
        remainder first, then subsequent lines) until `count` values read
        or a non-numeric token is hit."""
        hit = self._find(key)
        if hit is None:
            return None
        i, rest = hit
        vals = []

        def eat(tokens):
            for t in tokens:
                try:
                    vals.append(float(t))
                except ValueError:
                    return False
                if count is not None and len(vals) >= count:
                    return False
            return True

        cont = eat(rest)
        j = i + 1
        while cont and j < len(self.lines):
            line = self.lines[j].strip()
            j += 1
            if line.startswith("#") or not line:
                # reference's fscanf('%lf') would stop at '#'; blank ok
                if line.startswith("#"):
                    break
                continue
            toks = [t for t in self._DELIMS.split(line) if t]
            cont = eat(toks)
        if count is not None and len(vals) < count:
            return None
        a = np.array(vals if count is None else vals[:count])
        return a

    def get_table(self, key, rows, cols):
        a = self.get_array(key, rows * cols)
        if a is None:
            return None
        return a.reshape(rows, cols)


class ChainedConfig:
    """Two config files looked up in order.  The reference aliases
    physicsin to numericalin (psolve.c:644-648) so every key lives in one
    merged namespace; examples nonetheless split keys across the two
    files (e.g. test1 puts output_displacement in numerical.in).  Each
    lookup context prefers its historical file and falls back to the
    other."""

    def __init__(self, primary: ConfigFile, fallback: ConfigFile):
        self._primary = primary
        self._fallback = fallback
        self.path = primary.path

    def _get(self, name, key, *args, required=False, **kw):
        hit = getattr(self._primary, name)(key, *args, **kw)
        if hit is None:
            hit = getattr(self._fallback, name)(key, *args, **kw)
        if hit is None and required:
            raise KeyError(f"{self.path}: missing config key {key!r}")
        return hit

    def get_double(self, key, default=None, required=False):
        v = self._get("get_double", key, required=required)
        return default if v is None else v

    def get_int(self, key, default=None, required=False):
        v = self._get("get_int", key, required=required)
        return default if v is None else v

    def get_string(self, key, default=None, required=False):
        v = self._get("get_string", key, required=required)
        return default if v is None else v

    def get_array(self, key, count=None):
        return self._get("get_array", key, count)

    def get_table(self, key, rows, cols):
        return self._get("get_table", key, rows, cols)


@dataclass
class Params:
    """Full simulation parameter set (Param struct, psolve.c:193-286)."""

    # region / physics.in (psolve.c:698-705)
    region_origin_latitude_deg: float = 0.0
    region_origin_longitude_deg: float = 0.0
    region_azimuth_leftface_deg: float = 0.0
    region_depth_shallow_m: float = 0.0
    region_length_east_m: float = 0.0
    region_length_north_m: float = 0.0
    region_depth_deep_m: float = 0.0
    type_of_damping: str = "rayleigh"  # rayleigh|mass|none|bkt
    cvmdb_input_file: str = ""
    mesh_etree_output_file: str = "mesh.e"
    output_mesh: int = 0
    monitor_file: str = "monitor.txt"

    # numerical.in (psolve.c:748-801)
    freq: float = 0.0                      # simulation_wave_max_freq_hz
    ppw: float = 8.0                       # simulation_node_per_wavelength
    vscut: float = 0.0                     # simulation_shear_velocity_min
    start_time: float = 0.0
    end_time: float = 0.0
    delta_t: float = 0.0
    softening_factor: float = 0.0
    step_meshing: int = 0                  # use_progressive_meshing
    output_rate: int = 1
    freq_vel: float = 0.0                  # simulation_velocity_profile_freq_hz
    threshold_damping: float = 0.05
    threshold_vpvs: float = 3.0
    damping_statistics: int = 0
    auto_delta_t: int = 0                  # -DAUTO_DELTA_T equivalent
    use_infinite_qk: int = 0
    stiffness_method: str = "effective"
    print_matrix_k: int = 0
    schedule_print_file: int = 0
    schedule_print_error_check: int = 0
    schedule_print_stdout: int = 0
    stat_schedule_filename: str = "stat-sched.txt"
    stat_mesh_filename: str = "stat-mesh.txt"
    print_station_velocities: int = 0
    print_station_accelerations: int = 0
    timing_barriers: int = 0
    forces_buffer_size: int = 100_000_000

    # checkpoint
    use_checkpoint: int = 0
    checkpointing_rate: int = 0
    checkpoint_path: str = ""

    # 4D output
    output_parallel: int = 0
    output_displacement: int = 0
    output_velocity: int = 0
    output_displacement_file: str = "disp.h4d"
    output_velocity_file: str = "vel.h4d"
    output_stats_file: str = "output-stats.txt"

    # planes
    number_output_planes: int = 0
    planes_print_rate: int = 1
    planes_dir: str = ""
    planes: Optional[np.ndarray] = None    # [n, 9] table
    domain_surface_corners: Optional[np.ndarray] = None  # [4,2] lon/lat

    # stations
    number_output_stations: int = 0
    stations_print_rate: int = 1
    stations_dir: str = ""
    stations: Optional[np.ndarray] = None  # [n, 3] lat lon depth

    # source
    source_directory: str = ""
    source_directory_output: str = ""

    # feature toggles
    include_nonlinear: int = 0
    include_buildings: int = 0
    implement_drm: int = 0

    # mesh output extras
    mesh_coordinates_for_matlab: str = "no"
    mesh_coordinates_directory_for_matlab: str = ""
    # xmin ymin xmax ymax zmin zmax (m) of the region to dump for
    # MATLAB plotting (meshformatlab.c:98-115)
    mesh_corners_matlab: Optional[np.ndarray] = None

    # derived
    total_steps: int = 0
    delta_t_squared: float = 0.0
    factor: float = 0.0                    # freq * ppw (psolve.c:994)

    physics_path: str = ""
    numerical_path: str = ""

    def finalize(self):
        self.total_steps = int((self.end_time - self.start_time)
                               / self.delta_t)
        self.delta_t_squared = self.delta_t * self.delta_t
        self.factor = self.freq * self.ppw
        return self


def _yesno(v, default=0):
    if v is None:
        return default
    if isinstance(v, str):
        return 1 if v.lower() in ("yes", "1", "true") else 0
    return int(v)


def load_params(physics_in: str, numerical_in: Optional[str] = None) -> Params:
    """Parse physics.in (+ numerical.in, historically separate files now
    aliased to the same file, psolve.c:644-648) into Params."""
    phys = ConfigFile(physics_in)
    num = ConfigFile(numerical_in) if numerical_in else phys
    if num is not phys:
        phys, num = ChainedConfig(phys, num), ChainedConfig(num, phys)

    p = Params()
    p.physics_path = physics_in
    p.numerical_path = numerical_in or physics_in

    g = phys.get_double
    p.region_origin_latitude_deg = g("region_origin_latitude_deg", 0.0)
    p.region_origin_longitude_deg = g("region_origin_longitude_deg", 0.0)
    p.region_azimuth_leftface_deg = g("region_azimuth_leftface_deg", 0.0)
    p.region_depth_shallow_m = g("region_depth_shallow_m", 0.0)
    p.region_length_east_m = g("region_length_east_m", required=True)
    p.region_length_north_m = g("region_length_north_m", required=True)
    p.region_depth_deep_m = g("region_depth_deep_m", required=True)
    p.type_of_damping = phys.get_string("type_of_damping", "rayleigh")
    p.source_directory = phys.get_string("source_directory", "")
    p.source_directory_output = phys.get_string("source_directory_output", "")
    p.output_mesh = _yesno(phys.get_string("output_mesh"))
    p.output_parallel = _yesno(phys.get_string("output_parallel"))
    p.output_displacement = _yesno(phys.get_string("output_displacement"))
    p.output_velocity = _yesno(phys.get_string("output_velocity"))
    p.output_displacement_file = phys.get_string(
        "output_displacement_file", "disp.h4d")
    p.output_velocity_file = phys.get_string(
        "output_velocity_file", "vel.h4d")
    p.output_stats_file = phys.get_string(
        "output_stats_file", "output-stats.txt")

    n = num
    p.monitor_file = n.get_string("monitor_file",
                                  phys.get_string("monitor_file",
                                                  "monitor.txt"))
    p.freq = n.get_double("simulation_wave_max_freq_hz", required=True)
    p.ppw = n.get_double("simulation_node_per_wavelength", 8.0)
    p.vscut = n.get_double("simulation_shear_velocity_min", 0.0)
    p.start_time = n.get_double("simulation_start_time_sec", 0.0)
    p.end_time = n.get_double("simulation_end_time_sec", required=True)
    p.delta_t = n.get_double("simulation_delta_time_sec", required=True)
    p.softening_factor = n.get_double("softening_factor", 0.0)
    p.step_meshing = n.get_int("use_progressive_meshing", 0)
    p.output_rate = n.get_int("simulation_output_rate", 1)
    p.freq_vel = n.get_double("simulation_velocity_profile_freq_hz", 0.0)
    p.threshold_damping = n.get_double("the_threshold_damping", 0.05)
    p.threshold_vpvs = n.get_double("the_threshold_Vp_over_Vs", 3.0)
    p.damping_statistics = n.get_int("do_damping_statistics", 0)
    # the reference gates this behind -DAUTO_DELTA_T at compile time
    # (psolve.c:3033-3040); here it is a config key
    p.auto_delta_t = n.get_int("auto_delta_t", 0)
    p.use_infinite_qk = _yesno(n.get_string("use_infinite_qk"))
    p.stiffness_method = n.get_string("stiffness_calculation_method",
                                      "effective")
    p.print_matrix_k = _yesno(n.get_string("print_matrix_k"))
    # schedule/stat debug surface (psolve.c:785-801)
    p.schedule_print_file = n.get_int("schedule_print_file", 0)
    p.schedule_print_error_check = n.get_int(
        "schedule_print_error_check", 0)
    p.schedule_print_stdout = n.get_int("schedule_print_stdout", 0)
    p.stat_schedule_filename = n.get_string("stat_schedule_filename",
                                            "stat-sched.txt")
    p.stat_mesh_filename = n.get_string("stat_mesh_filename",
                                        "stat-mesh.txt")
    p.print_station_velocities = _yesno(
        n.get_string("print_station_velocities"))
    p.print_station_accelerations = _yesno(
        n.get_string("print_station_accelerations"))
    p.timing_barriers = _yesno(n.get_string("enable_timing_barriers"))
    fb = n.get_double("forces_buffer_size")
    if fb:
        p.forces_buffer_size = int(fb)

    p.use_checkpoint = n.get_int("use_checkpoint", 0)
    p.checkpointing_rate = n.get_int("checkpointing_rate", 0)
    p.checkpoint_path = n.get_string("checkpoint_path", "")

    p.cvmdb_input_file = n.get_string(
        "cvmdb_input_file", phys.get_string("cvmdb_input_file", ""))
    p.mesh_etree_output_file = n.get_string(
        "mesh_etree_output_file",
        phys.get_string("mesh_etree_output_file", "mesh.e"))

    # planes
    p.number_output_planes = n.get_int("number_output_planes", 0)
    if p.number_output_planes:
        p.planes_print_rate = n.get_int("output_planes_print_rate", 1)
        p.planes_dir = n.get_string("output_planes_directory", "")
        p.planes = n.get_table("output_planes", p.number_output_planes, 9)
    sc = n.get_table("domain_surface_corners", 4, 2)
    if sc is None:
        sc = phys.get_table("domain_surface_corners", 4, 2)
    p.domain_surface_corners = sc

    # stations
    p.number_output_stations = n.get_int("number_output_stations", 0)
    if p.number_output_stations:
        p.stations_print_rate = n.get_int("output_stations_print_rate", 1)
        p.stations_dir = n.get_string("output_stations_directory", "")
        p.stations = n.get_table("output_stations",
                                 p.number_output_stations, 3)

    p.include_nonlinear = _yesno(n.get_string("include_nonlinear_analysis"))
    p.include_buildings = _yesno(n.get_string("include_buildings"))
    p.implement_drm = _yesno(n.get_string("implement_drm"))

    p.mesh_coordinates_for_matlab = n.get_string(
        "mesh_coordinates_for_matlab", "no")
    p.mesh_coordinates_directory_for_matlab = n.get_string(
        "mesh_coordinates_directory_for_matlab", "")
    mc = n.get_array("mesh_corners_matlab", 6)
    if mc is None:
        mc = phys.get_array("mesh_corners_matlab", 6)
    p.mesh_corners_matlab = mc

    return p.finalize()
