"""Build and ctypes binding of the CUDA kernels in csrc/ (see build.py)."""
