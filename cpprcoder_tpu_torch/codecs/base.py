"""Backend and device selection for the port's codecs.

  "cuda":  tensors on the card; the hand-written kernels run.
  "torch": the plain PyTorch versions, on the CPU.
  "ref":   the JAX package's numpy oracle (cpprcoder_tpu/reference/).

All three write byte-identical containers. The device is explicit: with no
backend and no device the codec runs on "cuda", and raises when CUDA is not
available; the CPU is used only when asked for.
"""

from __future__ import annotations

import torch

BACKENDS = ("cuda", "torch", "ref")


def resolve(backend: str | None, device=None):
    """-> (backend, torch.device or None for "ref")."""
    if backend is None:
        backend = "torch" if device is not None and \
            torch.device(device).type == "cpu" else "cuda"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "ref":
        return backend, None
    dev = torch.device(device if device is not None else
                       ("cpu" if backend == "torch" else "cuda"))
    if backend == "torch" and dev.type != "cpu":
        raise ValueError("backend 'torch' runs the plain versions on the "
                         f"CPU; got device {dev}")
    if backend == "cuda":
        if dev.type != "cuda":
            raise ValueError(f"backend 'cuda' needs a CUDA device, got {dev}")
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "for the plain PyTorch path")
    return backend, dev
