"""The benchmark of hercules_tpu_torch, the PyTorch and CUDA port: its
harness, configurations, traffic mixes, per-layer metric readers,
roofline count and plain reference.  ``BENCHMARK.json`` at the root of
the repository names its cells; ``python3 -m port_bench.run`` runs one."""
