"""CT-PIPE codec composition of the port (counterpart of
cpprcoder_tpu/codecs/pipeline.py).

A pipeline is itself a codec: each stage's container feeds the next, and
the container is u8 stage count, the stages' codec ids, then the last
stage's container. The default stages are BASELINE's Config 4:
blocksort (2^19-byte blocks), mtf1, rle0, adaptive_range. `backend` and
`device` pass through to every stage, encode and decode alike.
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import get_codec, get_codec_by_id, register
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter

DEFAULT_STAGES = [("blocksort", {"block_log2": 19}), "mtf1", "rle0",
                  "adaptive_range"]


def pipeline_encode(data, stages: list | None = None, backend=None,
                    device=None) -> bytes:
    """Each stage is a codec name or a (name, encode_opts_dict) pair:
    encode-side options only; every CT container is self-describing, so
    decode needs just the codec ids."""
    stages = stages or DEFAULT_STAGES
    buf = data
    ids = []
    for stage in stages:
        name, stage_opts = stage if isinstance(stage, tuple) else (stage, {})
        codec = get_codec(name)
        buf = codec.encode(buf, backend=backend, device=device, **stage_opts)
        ids.append(codec.codec_id)
    w = ByteWriter().u8(len(ids))
    for i in ids:
        w.u8(i)
    w.raw(buf if isinstance(buf, bytes) else bytes(buf))
    return w.getvalue()


def pipeline_decode(blob, backend=None, device=None) -> bytes:
    r = ByteReader(blob)
    n_stages = r.u8()
    ids = [r.u8() for _ in range(n_stages)]
    buf = bytes(r.rest().tobytes())
    for cid in reversed(ids):
        buf = get_codec_by_id(cid).decode(buf, backend=backend, device=device)
    return buf


CODEC = register("pipeline", 9, pipeline_encode, pipeline_decode)
