"""Backend and device selection for the port's codecs.

  "cuda":  tensors on the card; the hand-written kernels run.
  "torch": the plain PyTorch versions, on the CPU.
  "ref":   the numpy oracle (the port's own copy, reference/).

All three write byte-identical containers. The device is explicit: with no
backend and no device the codec runs on "cuda", and raises when CUDA is not
available; the CPU is used only when asked for.
"""

from __future__ import annotations

import torch

BACKENDS = ("cuda", "torch", "ref")


def check_lane_count(lanes: int | None) -> None:
    """Raise ValueError unless `lanes` is None or a power of two: every
    container stores log2(K) in its lane descriptor, and the decoders read
    back 1 << that, so any other K writes a container that does not
    decode."""
    if lanes is not None and (lanes < 1 or lanes & (lanes - 1)):
        raise ValueError(f"lanes must be a power of two, got {lanes}")


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
