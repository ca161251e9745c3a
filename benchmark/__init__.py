"""The benchmark of ``oim_tpu_torch`` on NVIDIA GPUs.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything that belongs to one configuration, architecture family,
traffic mix or per-layer metric is a file of its own (``configs/``,
``families/``, ``traffic/``, ``metrics/``) that the harness finds by the
name ``BENCHMARK.json`` or the configuration gives.
"""
