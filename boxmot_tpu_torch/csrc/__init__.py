"""CUDA C++ sources of the kernels and their nvcc/ctypes builder."""
