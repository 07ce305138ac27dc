"""The benchmark of lbm_tpu_torch on one NVIDIA GPU: a data-driven
harness (run.py, harness.py), the cells' data (configs/, workloads/), the
per-layer metric readers (metrics/), the program's entries (entries/),
the yardstick (yardstick.py) and the plain reference that decides
`correct` (reference/)."""
