"""PyTorch / CUDA port of ``dreammesh4d_tpu`` for NVIDIA Hopper (H100).

Module paths mirror the JAX package so each counterpart is easy to find
(``dreammesh4d_tpu/ops/gs/projection.py`` ->
``dreammesh4d_tpu_torch/ops/gs/projection.py``).  The port imports torch,
numpy and scipy only — never jax or anything of ``dreammesh4d_tpu``.

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels (the CPU
tests do).  Hand-written CUDA kernels live in ``csrc/`` and are built with
``nvcc`` into ``_build/`` on first use (``cuda_build.py``).
"""

DEFAULT_DEVICE = "cuda"
