"""Plain PyTorch references the benchmark judges the port against.

Nothing here imports jax, sdflabel_tpu or sdflabel_tpu_torch: each file is
plain torch and numpy, and works out again from the benchmark's own inputs
what the timed path produced.
"""
