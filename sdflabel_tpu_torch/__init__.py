"""PyTorch/CUDA port of sdflabel_tpu for NVIDIA Hopper (H100).

The package mirrors ``sdflabel_tpu``'s module layout so that each module's
counterpart is easy to find. Plain tensor code is PyTorch; the kernels
that the JAX package wrote in Pallas are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, compiled with ``nvcc`` at first use
(``ops/_cuda.py``). Entry points default to ``device="cuda"``; the CPU
runs only when a caller asks for it, and then every kernel wrapper uses
its plain PyTorch version.
"""
