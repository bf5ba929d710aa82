"""cpprcoder_tpu_torch — the PyTorch/CUDA port of cpprcoder_tpu.

A second package beside the JAX one, which stays the reference: the same
container formats, written byte for byte alike, with each Pallas TPU kernel
replaced by a CUDA kernel written for Hopper (sm_90a, `csrc/`). It imports
torch and never jax, and nothing of the JAX package: it keeps its own
copies of the numpy-only host modules it needs (`config`, `core/`, the
numpy parts of `models/`, the oracles in `reference/`).

Public API:
    compress(data, codec="rans", device="cuda", **opts) -> bytes
    decompress(blob, codec="rans", device="cuda", **opts) -> bytes
    get_codec(name) -> Codec
    get_codec_by_id(codec_id) -> Codec
    list_codecs() -> list[str]

Codecs ported: static_range (CT-RC1), adaptive_range (CT-RC2),
rans (CT-ANS1 v2, the default, as in the JAX package), huffman (CT-HUF1),
blocksort (CT-BWT1), mtf (CT-MTF1), slz4 (CT-LZ4), ase (CT-ASE1),
mtf1 (CT-MTF1), pipeline (CT-PIPE), stream (CT-SB), adaptive_o1 (CT-RC3),
rle0 (CT-RLE0), adaptive_rans (CT-ANS2), rcq (CT-RCQ) and rcx (CT-RCX):
every codec of the JAX package.

slz4 writes the v2 parse on the card and the CPU and, like the JAX codec,
the v1 parse under backend="ref" (the oracle's default) and "native" (the
host library built from native/ctrc.cpp); as in the JAX package, the v1
parse runs on a device through ops.lz_ops.slz4_encode(parse="v1",
device=...) (kernel Z, then P and Q, on the card).

Streaming and resume (the JAX package's surface, checkpoints that cross
between the packages): `codecs.stream.SuperblockEncoder` and
`stream_decode_range` (CT-SB), and `codecs.resume.RCQResumableEncoder`
(CT-RCQ resumable mid-stream, kernel O on the card); each takes
`backend` and `device` as the codecs do.

The device is explicit: the default is the card, and `device="cpu"` runs
the plain PyTorch versions of the kernels (and the tensor code of the
transforms on the CPU). Below the codecs, the container
functions of `ops/` take `device` with no default. The kernels are
compiled with nvcc at first use on the card (native/build.py).
"""

from cpprcoder_tpu_torch.codecs import (  # noqa: F401
    compress,
    decompress,
    get_codec,
    get_codec_by_id,
    list_codecs,
)

__version__ = "0.1.0"
