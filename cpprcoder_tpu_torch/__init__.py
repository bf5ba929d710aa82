"""cpprcoder_tpu_torch — the PyTorch/CUDA port of cpprcoder_tpu.

A second package beside the JAX one, which stays the reference: the same
container formats, written byte for byte alike, with each Pallas TPU kernel
replaced by a CUDA kernel written for Hopper (sm_90a, `csrc/`). It imports
torch and never jax; it shares the JAX package's numpy-only host modules
(byte utilities, the numpy oracles, the parameter policy).

Public API:
    compress(data, codec="rcx", device="cuda", **opts) -> bytes
    decompress(blob, codec="rcx", device="cuda", **opts) -> bytes
    get_codec(name) -> Codec
    list_codecs() -> list[str]

The device is explicit: the default is the card, and `device="cpu"` runs
the plain PyTorch versions of the kernels. The kernels are compiled with
nvcc at first use on the card (native/build.py).
"""

from cpprcoder_tpu_torch.codecs import (  # noqa: F401
    compress,
    decompress,
    get_codec,
    list_codecs,
)

__version__ = "0.1.0"
