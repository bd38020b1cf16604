"""Plain PyTorch references of what the benchmark's cells run. Nothing here
imports the program (``msd_tpu_torch``), the JAX package or JAX."""
