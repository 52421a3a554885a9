"""4-D volume output writer (output.c:514-712, out_hdr_t in
psolve.h:118-188): a 136-byte header followed by
[output_steps, total_nodes, 3] float64 displacement (and/or velocity)
records, nodes ordered by global node id.

The reference computes per-PE offsets and fwrites in parallel
(compute_current_offset, output.c:1225-1230); here one host owns the
file and streams whole global snapshots (the gather happens on device,
the write on a background thread so the solver never blocks — the
moral equivalent of the reference's IO-pool PEs)."""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

HDR_DTYPE = np.dtype({
    "names": ["file_type_str", "format_version", "endiannes",
              "platform_id", "ufid", "total_nodes", "output_steps",
              "scalar_count", "scalar_size", "scalar_type",
              "scalar_class", "quantity_type", "domain_x", "domain_y",
              "domain_z", "mesh_ticksize", "delta_t", "total_elements",
              "output_rate", "total_time_steps", "generation_date"],
    "formats": ["S29", "i1", "i1", "i1", "(16,)u1", "<i8", "<i4",
                "<i4", "i1", "i1", "i1", "i1", "<f8", "<f8", "<f8",
                "<f8", "<f8", "<i8", "<i4", "<i4", "<i8"],
    "offsets": [0, 29, 30, 31, 32, 48, 56, 60, 64, 65, 66, 67, 72, 80,
                88, 96, 104, 112, 120, 124, 128],
    "itemsize": 136,
})

FORMAT_VERSION = 3


def output_step_count(total_steps, rate):
    """get_output_time_step_count: steps 0, rate, 2*rate, ..."""
    return (total_steps + rate - 1) // rate


class Output4D:
    """Async 4-D output file writer."""

    def __init__(self, path, mesh, params, quantity="displacement"):
        self.path = path
        self.N = mesh.nnum
        self.rate = params.output_rate
        self.out_steps = output_step_count(params.total_steps, self.rate)
        hdr = np.zeros(1, HDR_DTYPE)
        hdr["file_type_str"] = f"Hercules 4D output v{FORMAT_VERSION:03d}".encode()
        hdr["format_version"] = FORMAT_VERSION
        hdr["endiannes"] = 0
        hdr["platform_id"] = -1
        hdr["total_nodes"] = self.N
        hdr["output_steps"] = self.out_steps
        hdr["scalar_count"] = 3
        hdr["scalar_size"] = 8
        hdr["scalar_type"] = 2   # FLOAT64
        hdr["scalar_class"] = 1  # FLOAT_CLASS
        hdr["quantity_type"] = 1 if quantity == "displacement" else 2
        hdr["domain_x"] = params.region_length_north_m
        hdr["domain_y"] = params.region_length_east_m
        hdr["domain_z"] = params.region_depth_deep_m
        hdr["mesh_ticksize"] = mesh.ticksize
        hdr["delta_t"] = params.delta_t
        hdr["total_elements"] = mesh.lenum
        hdr["output_rate"] = self.rate
        hdr["total_time_steps"] = params.total_steps
        hdr["generation_date"] = int(time.time())
        self.hdr = hdr
        self.stride = self.N * 3 * 8
        self.fp = open(path, "wb")
        self.fp.write(hdr.tobytes())
        self._q = queue.Queue(maxsize=4)
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()
        self.written = 0
        self.io_seconds = 0.0
        self.io_bytes = 0
        self.max_latency = 0.0

    def _writer(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            step_idx, data = item
            t0 = time.perf_counter()
            self.fp.seek(136 + step_idx * self.stride)
            data.astype("<f8").tofile(self.fp)
            dt = time.perf_counter() - t0
            self.io_seconds += dt
            self.io_bytes += self.stride
            self.max_latency = max(self.max_latency, dt)

    def maybe_write(self, step, u_global):
        """Write if step is an output step (step % rate == 0 and within
        the reference's 0..total_steps-1 tap range)."""
        if step % self.rate or step // self.rate >= self.out_steps:
            return False
        self._q.put((step // self.rate, np.asarray(u_global)))
        self.written += 1
        return True

    def close(self):
        self._q.put(None)
        self._thread.join()
        self.fp.close()

    def write_stats(self, path):
        """4-D output I/O statistics (output_collect_stats /
        print report, output.c:279-404, 1107-1175)."""
        with open(path, "w") as f:
            f.write("# 4D output I/O statistics\n")
            f.write(f"file                 = {self.path}\n")
            f.write(f"output steps written = {self.written}\n")
            f.write(f"bytes written        = {self.io_bytes}\n")
            f.write(f"io wall seconds      = {self.io_seconds:.3f}\n")
            f.write(f"max write latency s  = {self.max_latency:.4f}\n")
            if self.io_seconds > 0:
                f.write(f"throughput MB/s      = "
                        f"{self.io_bytes / self.io_seconds / 1e6:.1f}\n")
            exp = 136 + self.out_steps * self.stride
            f.write(f"expected file size   = {exp}\n")


def read_4d(path):
    """Read a 4-D output file -> (header record, data [S, N, 3])."""
    with open(path, "rb") as f:
        hdr = np.frombuffer(f.read(136), HDR_DTYPE)[0]
        n = int(hdr["total_nodes"])
        s = int(hdr["output_steps"])
        data = np.fromfile(f, "<f8", s * n * 3).reshape(s, n, 3)
    return hdr, data
