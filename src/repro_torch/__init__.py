"""PyTorch/CUDA port of the multiplier-free DA serving stack.

Mirrors the module layout of the JAX reference package ``repro`` (which it
never imports): ``core`` (DA identity, quantization, engine, freeze),
``kernels`` (hand-written Hopper CUDA kernels with their plain PyTorch
versions), ``models``, ``configs`` and ``serve``.  ``convert`` carries JAX
parameters across as numpy arrays.
"""
