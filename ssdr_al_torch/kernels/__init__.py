"""nvcc build and ctypes binding of the port's CUDA kernels (csrc/*.cu)."""
