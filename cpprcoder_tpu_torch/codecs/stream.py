"""CT-SB superblock streaming codec of the port (counterpart of
cpprcoder_tpu/codecs/stream.py; same container, same checkpoint).

Splits an input into fixed superblocks (default 2^25 bytes), codes each
apart with a registered codec, and concatenates their containers behind a
size table. Device memory is bounded by one superblock whatever the input's
size; finished superblocks are the unit of resume (`SuperblockEncoder`) and
of seek (`stream_decode_range`).

Layout:
    u8  codec_id
    u8  sb_log2
    u32 n_superblocks
    n x u32 container sizes
    n containers

An empty input is one superblock holding the codec's empty container. The
backend and device reach every superblock's encode and decode
(codecs/base.py: the card unless the CPU is asked for); the codec's own
options reach its encode. A header naming a codec that is not ported yet
raises the registry's KeyError, which names its ROADMAP item.
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import get_codec, get_codec_by_id, register
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8

CKPT_FORMAT = "CT-SB-ckpt-v1"


def _container(codec_id: int, sb_log2: int, blobs: list[bytes]) -> bytes:
    w = ByteWriter().u8(codec_id).u8(sb_log2).u32(len(blobs))
    w.u32s([len(b) for b in blobs])
    for b in blobs:
        w.raw(b)
    return w.getvalue()


def _parse(blob):
    """-> (codec, sb_log2, container sizes, reader at the first one)."""
    r = ByteReader(blob)
    codec = get_codec_by_id(r.u8())
    sb_log2 = r.u8()
    n_sb = r.u32()
    return codec, sb_log2, r.u32s(n_sb).astype(int), r


def stream_encode(data, codec: str = "rans", sb_log2: int = 25, backend=None,
                  device=None, **opts) -> bytes:
    x = as_u8(data)
    c = get_codec(codec)
    sb = 1 << sb_log2
    blobs = [c.encode(x[i:i + sb], backend=backend, device=device, **opts)
             for i in range(0, max(len(x), 1), sb)]
    return _container(c.codec_id, sb_log2, blobs)


def stream_decode(blob, backend=None, device=None) -> bytes:
    c, _, sizes, r = _parse(blob)
    return b"".join(c.decode(r.raw(int(s)).tobytes(), backend=backend,
                             device=device) for s in sizes)


CODEC = register("stream", 10, stream_encode, stream_decode)


class SuperblockEncoder:
    """Incremental CT-SB encoder with checkpoint/resume: feed bytes in any
    pieces, snapshot at superblock granularity, resume from the snapshot
    (in this package or the JAX one) without coding finished superblocks
    again.

        enc = SuperblockEncoder("adaptive_range")
        enc.feed(piece); ...
        ckpt = enc.checkpoint()          # plain dict, picklable
        enc2 = SuperblockEncoder.resume(ckpt)
        enc2.feed(rest)
        blob = enc2.finish()

    The checkpoint holds the codec's name, not its options: pass them to
    resume() again."""

    def __init__(self, codec: str = "rans", sb_log2: int = 25, backend=None,
                 device=None, **opts):
        self._codec = get_codec(codec)
        self._sb_log2 = sb_log2
        self._kw = dict(backend=backend, device=device, **opts)
        self._blobs: list[bytes] = []
        self._pending = bytearray()

    def _encode(self, data) -> bytes:
        return self._codec.encode(data, **self._kw)

    def feed(self, data) -> int:
        """Buffer input and code every completed superblock; -> the number
        of superblocks this call finished."""
        self._pending += as_u8(data).tobytes()
        sb = 1 << self._sb_log2
        done = len(self._pending) // sb
        self._blobs += [self._encode(bytes(self._pending[i * sb:(i + 1) * sb]))
                        for i in range(done)]
        del self._pending[:done * sb]
        return done

    def checkpoint(self) -> dict:
        """The finished superblocks' containers and the bytes not coded
        yet, as plain picklable values (the JAX package's keys)."""
        return {"format": CKPT_FORMAT, "codec": self._codec.name,
                "sb_log2": self._sb_log2, "blobs": list(self._blobs),
                "pending": bytes(self._pending)}

    @classmethod
    def resume(cls, ckpt: dict, backend=None, device=None,
               **opts) -> "SuperblockEncoder":
        if ckpt.get("format") != CKPT_FORMAT:
            raise ValueError("not a CT-SB checkpoint")
        enc = cls(ckpt["codec"], ckpt["sb_log2"], backend=backend,
                  device=device, **opts)
        enc._blobs = list(ckpt["blobs"])
        enc._pending = bytearray(ckpt["pending"])
        return enc

    def finish(self) -> bytes:
        """Code the tail (or the empty input's one superblock) and return
        the CT-SB container."""
        if self._pending or not self._blobs:
            self._blobs.append(self._encode(bytes(self._pending)))
            self._pending.clear()
        return _container(self._codec.codec_id, self._sb_log2, self._blobs)


def stream_decode_range(blob, start: int, stop: int, backend=None,
                        device=None) -> bytes:
    """Bytes [start, stop) of the input, decoding only the superblocks
    that cover them."""
    c, sb_log2, sizes, r = _parse(blob)
    sb = 1 << sb_log2
    base = r.pos
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + s)
    first = max(0, start // sb)
    last = min(len(sizes), -(-stop // sb)) if stop > start else first
    joined = b"".join(
        c.decode(r.buf[base + offsets[i]:base + offsets[i + 1]].tobytes(),
                 backend=backend, device=device)
        for i in range(first, last))
    lo = start - first * sb
    return joined[lo:lo + (stop - start)]
