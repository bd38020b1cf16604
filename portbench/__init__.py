"""The benchmark of ``msd_tpu_torch`` on one H100 (see README.md): one
command runs one cell once, and every configuration, cell, driver and
per-layer metric is a file of its own, found by name."""
