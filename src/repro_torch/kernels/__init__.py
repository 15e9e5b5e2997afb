"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) with their ctypes
wrappers and plain torch versions.  Nothing is built at import."""
