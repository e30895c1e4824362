"""The benchmark of sdflabel_tpu_torch on an NVIDIA H100 (see PERF.md)."""
