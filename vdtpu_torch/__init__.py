"""Versatile Diffusion on PyTorch and CUDA: the port of the JAX package
``vdtpu`` to one NVIDIA H100. Modules keep the JAX package's names."""
