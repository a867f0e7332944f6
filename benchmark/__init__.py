"""Benchmark of slam_plus_plus_tpu_torch on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything a
cell is made of is a file found by name: its configuration
(``configs/<config>.json``), its traffic (``traffic/<mix>.json``, which
names the module of ``drivers/`` that runs it), its limits
(``limits/<cell>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``).
"""
