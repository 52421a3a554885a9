"""One run of one cell: the inputs from the seed, the program's set-up,
its time loop with the measured window, the check against the
reference, and the result.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``), each per-layer metric has its reader
(``metrics/<name>.py``) and each cell its limits (``limits/<cell>.json``).

The window drives the time loop of one long run through the program's
route functions, the ones ``Simulation.run`` calls for ``solver="auto"``
(``run_pallas_solver`` for a single brick, ``run_mesh_solver``
otherwise; on a cell of several cards its multi-card pipeline,
``Simulation._run_multichip``, a rank on each card), with the same
arguments and two hooks of the benchmark's:
``on_samples`` keeps the receivers' samples of the chunks that are
checked, ``on_chunk`` watches the chunk boundaries.  ``Simulation.run``
itself takes no ``on_samples`` hook, so without it the samples of the
checked chunks could not be kept.  The window opens at the first
boundary (the first chunk, which loads the kernels, is set-up) and
closes at the first boundary after ``seconds``, where the hook ends the
run.

The set-up is that of a user's job of the traffic's ``job_steps`` steps:
the program computes the source forces of those steps.  The loop is
given more steps than any program could finish inside the window, and
past the job's end the forces hold their last value (``HeldForces``);
the reference does the same.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "hercules_tpu")
# every key a traffic mix may hold, each read by the harness; "what" is
# the mix's one line of prose
TRAFFIC_KEYS = ("what", "chunk_steps", "job_steps", "rate_seconds",
                "trace_seconds")


class WindowClosed(Exception):
    """Raised by the window's hook to end the program's run."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def manifest(root):
    """BENCHMARK.json at the checkout's root."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json in {root}")
    return load_json(path)


def find(man, workload, base=HERE):
    """(cell entry, configuration, traffic mix, limits) of ``workload``,
    from their files under ``base``."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = load_json(os.path.join(base, "configs", cell["config"] + ".json"))
    traffic = load_json(os.path.join(base, "traffic",
                                     cell["traffic"] + ".json"))
    unread = set(traffic) - set(TRAFFIC_KEYS)
    if unread:
        raise KeyError(f"traffic {cell['traffic']!r} holds keys the "
                       f"harness does not read: {sorted(unread)}")
    limits = load_json(os.path.join(base, "limits", workload + ".json"))
    return cell, cfg, traffic, limits


def cell_metrics(man, workload):
    """(end-to-end metrics, per-layer metrics) the cell reports."""
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def reader(name, directory=None):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = os.path.join(directory or os.path.join(HERE, "metrics"),
                        name + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------- inputs

def receivers(cfg):
    """[R, 3] receiver points (north, east, depth) m: a list, or a grid
    of ``counts`` points along each of its ``steps`` vectors from
    ``first`` (the last axis varies fastest)."""
    if "receivers_list_m" in cfg:
        return np.asarray(cfg["receivers_list_m"], np.float64)
    r = cfg["receivers_m"]
    axes = np.meshgrid(*[np.arange(n) for n in r["counts"]],
                       indexing="ij")
    k = np.stack([a.ravel() for a in axes], 1).astype(np.float64)
    return np.asarray(r["first"], np.float64) + k @ np.asarray(
        r["steps"], np.float64)


def draw_source(cfg, seed, rows):
    """The source of this seed: the published hypocentre moved by (0.1 +
    0.8 u) of the edge of the element that holds it on each axis, so that
    it lies inside one element, and the double couple's angles drawn
    (see the configuration's ``seed_draws``)."""
    src = dict(cfg["source_model"])
    rng = np.random.default_rng(seed)
    hyp = np.asarray(src["hypocentre_m"], np.float64)
    tops = [z0 for z0, _ in rows]
    edge = rows[max(0, np.searchsorted(tops, hyp[2], side="right") - 1)][1]
    src["hypocentre_m"] = (hyp + (0.1 + 0.8 * rng.random(3)) * edge).tolist()
    src["strike_deg"] = float(rng.uniform(0.0, 360.0))
    src["dip_deg"] = float(rng.uniform(20.0, 80.0))
    src["rake_deg"] = float(rng.uniform(-180.0, 180.0))
    return src


def run_steps(cfg, traffic, rows, seconds):
    """Steps of the loop: the window's seconds at the least time a step
    can take on any route on the configuration's cards
    (``roofline.floor_step_seconds``), and two chunks more (the set-up's
    and the one the window closes on), in whole chunks; so no program,
    however fast, runs out of steps inside the window.  Steps past the
    job's cost nothing in set-up (``HeldForces``)."""
    from .roofline import bricks, floor_step_seconds
    chunk = traffic["chunk_steps"]
    least = floor_step_seconds(bricks(rows, extents(cfg)), cfg["precision"],
                               cfg["chips"])
    return chunk * (math.ceil(seconds / least / chunk) + 2)


class HeldForces:
    """The program's source forces [T, L, 3] of a job of T steps, read
    by slices of steps as the routes read them; past step T - 1 each
    step takes step T - 1's forces."""

    def __init__(self, forces):
        self.forces = np.asarray(forces)

    @property
    def shape(self):
        """The job's [T, L, 3], as the multi-card loop reads it."""
        return self.forces.shape

    def __getitem__(self, steps):
        f = self.forces
        T = len(f)
        s, e = steps.start, steps.stop
        if e <= T:
            return f[s:e]
        held = np.broadcast_to(f[T - 1], (e - max(s, T),) + f.shape[1:])
        return np.concatenate([f[min(s, T):T], held])


def extents(cfg):
    """(north, east, depth) m of the configuration's domain."""
    r = cfg["region_m"]
    return (r["north"], r["east"], r["depth"])


def write_inputs(workdir, cfg, src, recv, steps):
    """The run's etree, ``in/physics.in``, ``in/numerical.in`` and
    ``in/src/source.in`` under ``workdir``; returns (cvmdb, physics,
    numerical)."""
    from hercules_tpu_torch.tools.makecvm import build_layered_cvm
    r = cfg["region_m"]
    os.makedirs(os.path.join(workdir, "in", "src"), exist_ok=True)
    cvmdb = os.path.join(workdir, "medium.e")
    build_layered_cvm(cvmdb, r["east"], r["north"], r["depth"],
                      cfg["cvm_resolution_m"], cfg["layers"])
    corners = " 0 0\n 0 1\n 1 1\n 1 0\n"          # lon lat: lat = x / north
    physics = os.path.join(workdir, "in", "physics.in")
    with open(physics, "w") as f:
        f.write(f"region_origin_latitude_deg  = 0\n"
                f"region_origin_longitude_deg = 0\n"
                f"region_depth_shallow_m      = 0\n"
                f"region_length_east_m        = {r['east']!r}\n"
                f"region_length_north_m       = {r['north']!r}\n"
                f"region_depth_deep_m         = {r['depth']!r}\n"
                f"region_azimuth_leftface_deg = 0\n"
                f"type_of_damping             = {cfg['damping']}\n"
                f"source_directory            = in/src\n")
    dt = cfg["dt_s"]
    st = "".join(f" {float(x) / r['north']!r} {float(y) / r['east']!r} "
                 f"{float(z)!r}\n" for x, y, z in recv)
    numerical = os.path.join(workdir, "in", "numerical.in")
    with open(numerical, "w") as f:
        f.write(f"simulation_wave_max_freq_hz    = {cfg['fmax_hz']!r}\n"
                f"simulation_node_per_wavelength = "
                f"{cfg['points_per_wavelength']}\n"
                f"simulation_shear_velocity_min  = 500\n"
                f"simulation_start_time_sec      = 0\n"
                f"simulation_end_time_sec        = {(steps + 0.5) * dt!r}\n"
                f"simulation_delta_time_sec      = {dt!r}\n"
                f"the_threshold_damping          = 0.05\n"
                f"the_threshold_Vp_over_Vs       = 3\n"
                f"number_output_stations         = {len(recv)}\n"
                f"output_stations_print_rate     = 1\n"
                f"output_stations_directory      = stations\n"
                f"output_stations =\n{st}\n"
                f"domain_surface_corners =\n{corners}\n")
    h = src["hypocentre_m"]
    with open(os.path.join(workdir, "in", "src", "source.in"), "w") as f:
        f.write(f"type_of_source       = point\n"
                f"source_function_type = {src['function']}\n"
                f"average_risetime_sec = {src['risetime_s']!r}\n"
                f"lonlat_or_cartesian  = 1\n"
                f"hypocenter_x         = {h[0]!r}\n"
                f"hypocenter_y         = {h[1]!r}\n"
                f"hypocenter_depth_m   = {h[2]!r}\n"
                f"moment_amplitude     = {src['moment_nm']!r}\n"
                f"source_strike_deg    = {src['strike_deg']!r}\n"
                f"source_dip_deg       = {src['dip_deg']!r}\n"
                f"source_rake_deg      = {src['rake_deg']!r}\n"
                f"domain_surface_corners =\n{corners}\n")
        if src.get("filter_hz"):
            f.write(f"source_is_filtered   = 1\n"
                    f"threshold_frequency  = {src['filter_hz']!r}\n"
                    f"number_of_poles      = {src['filter_poles']}\n")
        else:
            f.write("source_is_filtered   = 0\n")
    return cvmdb, physics, numerical


# ---------------------------------------------------------------- window

class Window:
    """The hooks that watch the program's chunk boundaries.

    The window opens at the first boundary.  Untraced, it measures from
    there and closes at the first boundary at least ``seconds`` later.
    Traced (``tracer`` given), it first runs ``rate_seconds`` untraced
    and keeps their steps and wall time (``untraced``, read where the
    profiler would slow the host), then starts the profiler at a
    boundary, lets it warm up for a chunk, measures from the next
    boundary and closes at the first one at least ``seconds`` later.
    One chunk of the window, drawn uniformly from the seed by reservoir
    sampling over the chunks as they start, is kept for the check: its
    start state, its receivers' samples and its end state; the set-up's
    chunk's samples are kept too."""

    def __init__(self, seconds, chunk, seed, snapshot, tracer=None,
                 rate_seconds=0.0):
        self.seconds, self.chunk = seconds, chunk
        self.rate_seconds = rate_seconds
        self.snapshot = snapshot          # state -> tensors to keep
        self.make_tracer = tracer
        self.tracer = None
        self.trace = None
        self.untraced = None              # (steps, seconds) before tracing
        self.rng = np.random.default_rng([seed, 1])
        self.t_setup = self.t_start = self.t_close = None
        self.open_step = self.start_step = self.close_step = None
        self.first_samples = None
        self.seen = 0                     # window chunks started
        self.kept = None                  # (step, start tensors)
        self.kept_samples = None
        self.kept_end = None
        self.candidate = None
        self.candidate_samples = None
        self.boundaries = []

    def on_samples(self, s0, ys):
        if s0 == 0:
            self.first_samples = np.array(ys)
        if self.candidate is not None and s0 == self.candidate[0]:
            self.candidate_samples = np.array(ys)
        return ys[:, :0]

    def _phase(self, done, now):
        """Moves on from the untraced stretch to the profiler's warm-up
        and from there to the measured stretch."""
        if self.make_tracer is None:
            self.t_start, self.start_step = now, done
        elif self.tracer is None:
            if now - self.t_setup >= self.rate_seconds:
                self.untraced = (done - self.open_step, now - self.t_setup)
                self.tracer = self.make_tracer()
        else:
            self.tracer.open()
            self.t_start, self.start_step = time.perf_counter(), done
            self.boundaries[-1] = self.t_start

    def on_chunk(self, done, state):
        now = time.perf_counter()
        self.boundaries.append(now)
        if self.t_setup is None:
            self.t_setup, self.open_step = now, done
        elif self.candidate is not None and \
                done == self.candidate[0] + self.chunk:
            self.kept = self.candidate
            self.kept_samples = self.candidate_samples
            self.kept_end = self.snapshot(state)
            self.candidate = None
        if self.t_start is None:
            self._phase(done, now)
        elif now - self.t_start >= self.seconds:
            self.t_close, self.close_step = now, done
            if self.tracer is not None:
                self.trace = self.tracer.stop()
            raise WindowClosed
        self.seen += 1
        if self.rng.random() * self.seen < 1.0:
            self.candidate = (done, self.snapshot(state))
            self.candidate_samples = None

    @property
    def steps(self):
        """Steps of the measured stretch."""
        return self.close_step - self.start_step

    @property
    def elapsed(self):
        return self.t_close - self.t_start

    def chunk_seconds(self):
        """Wall seconds of each chunk of the measured stretch."""
        t = np.array(self.boundaries)
        return np.diff(t[-(self.steps // self.chunk) - 1:])
