"""PyTorch/CUDA port of the hibernate-container LLM serving system.

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX.  Plain tensor code is PyTorch; every Pallas TPU kernel on the
ported path is a hand-written CUDA kernel for Hopper (sm_90a) under
``csrc/``, built on first use (:mod:`repro_torch.kernels`).
"""
