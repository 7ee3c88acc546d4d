"""dgen_tpu_torch: the PyTorch / CUDA port of dgen_tpu for NVIDIA Hopper.

The JAX package ``dgen_tpu`` is the reference; this package runs the
same model-year path with PyTorch, its bucket-sums engines as CUDA
kernels written for sm_90a (``csrc/``). Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``, where
every kernel is replaced by its plain PyTorch version. Nothing here
imports jax or dgen_tpu.
"""
