"""Mid-stream resumable CT-RCQ encoder of the port (counterpart of
cpprcoder_tpu/codecs/resume.py; same checkpoint, key for key, so that a
checkpoint written by either package resumes in the other).

The K-lane coder state (low, carry, range, cache, cache_size) and the
model counts C are all an encode carries from one step to the next, so a
snapshot at any chunk boundary (a chunk is `chunk_steps` steps of K
symbols) captures everything needed to resume. Each chunk runs kernel O
(ops/rcq_kernels.encode_chunk: kernel D from the saved state), then kernel
B turns its events into per-lane payload bytes (dropping each lane's first
emitted byte, the coder's dummy, only for lanes that never emitted
before), and the chunk's lane-major payload and lane sizes come to the
host as FRAGMENTS. The state, C and the lanes that never emitted stay on
the device between chunks; checkpoint() copies them to numpy.

finish() codes the remaining steps and the flush in one launch of O and
joins each lane's fragments: the container is byte-identical to one-shot
`rcq` on the same data and parameters. (The JAX class replays the one-shot
encoder's `bucket` padding steps too; they are inactive and change no
coder state, so the bytes are the same.)
"""

from __future__ import annotations

import numpy as np
import torch

from cpprcoder_tpu_torch.codecs.base import check_lane_count, resolve
from cpprcoder_tpu_torch.models.cxmodel import rcq_params
from cpprcoder_tpu_torch.ops import expand, layout, rc_common, rcq_kernels, rcq_ops

# a checkpoint's state vectors: low, carry, range, cache, cache_size
_STATE0 = (0, 0, rc_common.MASK32, 0, 1)


class RCQResumableEncoder:
    """Incremental CT-RCQ encoder with mid-stream checkpoint/resume, on the
    card unless the CPU is asked for (backend "torch" or device "cpu": the
    plain versions of kernels O and B)."""

    def __init__(self, total_n: int, lanes: int | None = None,
                 inc: int | None = None, climit_log2: int | None = None,
                 chunk_steps: int = 64, *, backend=None, device=None):
        check_lane_count(lanes)
        backend, self._dev = resolve(backend, device)
        if backend == "ref":
            raise ValueError("the resumable encoder runs on backend 'cuda' "
                             "or 'torch'; the oracle codes whole inputs "
                             "(rcq with backend 'ref')")
        if chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        k, inc0, cl0 = rcq_params(total_n, lanes)
        self.n = total_n
        self.k = k
        self.inc = inc0 if inc is None else inc
        self.cl = cl0 if climit_log2 is None else climit_log2
        self.chunk_steps = chunk_steps
        stride = -(-total_n // k)
        # a lane's pending run of 0xFF bytes must fit the event's 22-bit
        # field, across chunks as within one
        if 3 * stride + 2 >= 1 << rc_common.EV_RUN_BITS:
            raise ValueError(f"{total_n} bytes over {k} lanes exceed one "
                             f"container (stride {stride}); split the input")
        self._climit = rc_common.climit_u32(self.cl, total_n, self.inc)
        self._lane_len = layout.lane_lengths_interleaved(total_n, k, stride,
                                                         self._dev)
        self._buf = bytearray()
        self._frag_payload: list[bytes] = []      # chunk payloads
        self._frag_sizes: list[np.ndarray] = []   # lane sizes a chunk
        self._t0 = 0
        self._fed = 0
        self._set_state(np.array([np.full(k, v, np.uint32) for v in _STATE0]),
                        np.ones(256, np.uint32), np.ones(k, bool))

    def _set_state(self, state, C, never_emitted):
        """The coder state [5, K] and the counts (u32, held as int32 bits)
        and the lanes that never emitted, from numpy onto the device."""
        def dev(a, dtype):
            a = np.ascontiguousarray(np.asarray(a, dtype))
            return torch.from_numpy(a.view(np.int32) if dtype == np.uint32
                                    else a).to(self._dev)
        self._state = dev(np.reshape(state, (5, self.k)), np.uint32)
        self._C = dev(C, np.uint32)
        self._never_emitted = dev(never_emitted, bool)

    # -------------------------------------------------------------- feed
    def feed(self, data) -> int:
        """Buffer input and code every whole chunk; -> the bytes buffered
        after this call."""
        self._buf.extend(data)
        self._fed += len(data)
        if self._fed > self.n:
            raise ValueError("fed more than total_n bytes")
        chunk = self.chunk_steps * self.k
        done = len(self._buf) // chunk
        for i in range(done):
            self._run_chunk(self._buf[i * chunk:(i + 1) * chunk],
                            self.chunk_steps)
        del self._buf[:done * chunk]
        return len(self._buf)

    def _run_chunk(self, raw, steps: int, flush: bool = False):
        """Kernel O over `steps` steps of `raw` (zero past its end), then
        kernel B under the never-emitted mask; the chunk's fragment to the
        host."""
        x = np.zeros((steps, self.k), np.uint8)
        x.reshape(-1)[:len(raw)] = np.frombuffer(raw, np.uint8)
        ev, self._state, self._C = rcq_kernels.encode_chunk(
            torch.from_numpy(x).to(self._dev), self._lane_len, self._t0,
            self._state, self._C, self.inc, self._climit, flush)
        rows, sizes = expand.materialize_rows(ev, may_drop=self._never_emitted)
        self._never_emitted &= ~(ev < 0).any(dim=0)   # bit 31: an emit
        keep = torch.arange(rows.shape[1], device=rows.device)[None, :] \
            < sizes[:, None]
        self._frag_payload.append(rows[keep].cpu().numpy().tobytes())
        self._frag_sizes.append(sizes.cpu().numpy().astype(np.int64))
        self._t0 += steps

    # -------------------------------------------------- checkpoint/resume
    def checkpoint(self) -> dict:
        """Plain-numpy snapshot (picklable), with the JAX class's keys and
        dtypes; resume() in either package restores it."""
        state = self._state.cpu().numpy().view(np.uint32)
        return {
            "n": self.n, "k": self.k, "inc": self.inc, "cl": self.cl,
            "chunk_steps": self.chunk_steps, "t0": self._t0,
            "fed": self._fed, "buf": bytes(self._buf),
            "state": [row.copy() for row in state],
            "C": self._C.cpu().numpy().view(np.uint32).copy(),
            "never_emitted": self._never_emitted.cpu().numpy().copy(),
            "frag_payload": list(self._frag_payload),
            "frag_sizes": [s.copy() for s in self._frag_sizes],
        }

    @classmethod
    def resume(cls, ckpt: dict, *, backend=None,
               device=None) -> "RCQResumableEncoder":
        enc = cls(ckpt["n"], lanes=ckpt["k"], inc=ckpt["inc"],
                  climit_log2=ckpt["cl"], chunk_steps=ckpt["chunk_steps"],
                  backend=backend, device=device)
        enc._t0 = int(ckpt["t0"])
        enc._fed = int(ckpt["fed"])
        enc._buf = bytearray(ckpt["buf"])
        enc._set_state(np.stack([np.asarray(a) for a in ckpt["state"]]),
                       ckpt["C"], ckpt["never_emitted"])
        enc._frag_payload = list(ckpt["frag_payload"])
        enc._frag_sizes = [np.asarray(s, np.int64) for s in ckpt["frag_sizes"]]
        return enc

    # ------------------------------------------------------------ finish
    def finish(self) -> bytes:
        if self._fed != self.n:
            raise ValueError(f"fed {self._fed} of {self.n} bytes")
        if self.n == 0:
            return rcq_ops.header(0, self.k, False, self.inc,
                                  self.cl).getvalue()
        # the remaining steps (none when the chunks ended on the last) and
        # the flush, in one launch
        self._run_chunk(self._buf, -(-self.n // self.k) - self._t0,
                        flush=True)
        self._buf.clear()
        return layout.assemble_payload(
            lambda wide: rcq_ops.header(self.n, self.k, wide, self.inc,
                                        self.cl),
            *stitch(self._frag_payload, np.stack(self._frag_sizes)))


def stitch(frags: list[bytes], sizes: np.ndarray):
    """Per-chunk fragments -> (payload, lane sizes [K]): the payload holds
    lane after lane, each lane's bytes in chunk order. frags[c] is chunk
    c's lane-major payload and sizes[c] ([chunks, K] int64) its lane
    sizes."""
    flat = np.frombuffer(b"".join(frags), np.uint8)
    lane_sizes = sizes.sum(axis=0)
    seg = sizes.reshape(-1)                  # fragment (c, i), c-major
    src = np.cumsum(seg) - seg               # its start in the joined frags
    dst = ((np.cumsum(lane_sizes) - lane_sizes)[None, :]
           + np.cumsum(sizes, axis=0) - sizes).reshape(-1)   # in the payload
    payload = np.empty_like(flat)
    payload[np.arange(len(flat)) + np.repeat(dst - src, seg)] = flat
    return payload, lane_sizes
