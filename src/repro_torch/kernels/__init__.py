"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) with their plain
PyTorch versions.  A wrapper given a CPU tensor runs the plain version; given
a CUDA tensor it launches its kernel or raises."""
