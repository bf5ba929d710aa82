"""Benchmark inputs of the port (its own copies of the numpy-only parts
of cpprcoder_tpu/bench/), made on machines without JAX."""
