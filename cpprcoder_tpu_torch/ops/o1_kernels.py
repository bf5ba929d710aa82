"""Kernel U and V wrappers: CT-RC3 (the order-1 blended range coder) encode
and decode on the card.

The JAX package has no Pallas kernel here: it runs each direction as one
compiled `lax.scan` (cpprcoder_tpu/ops/o1_ops.py:132 `_encode_fn`, scan
:156; :169 `_decode_fn`, scan :209), reading the model's rows by one-hot
matrix products on the TPU's matrix unit. On Hopper the rows are read by
direct index. Kernel U (`csrc/o1_encode.cu`) encodes, kernel V
(`csrc/o1_decode.cu`) decodes; both share `csrc/o1_model.cuh`.

All K lanes share the model and update it every step, so the model runs
in one CTA a stream (256 to 1,024 threads; lanes past 1,024 are taken in
turn by each thread). The model lives in shared memory: t1 as u16 pairs
(128 KiB) where its counts stay below 2^16 (`o1_ops.table_wide` false),
else as u32 in global memory (L2-resident); beside it, per row 16 block
sums of 16 counts (u32) and the row total, and t0 with its block sums and
total. A step is three phases between barriers: the rescale (every row
checked, strided over the warps; a warp halves a row that has reached its
limit and rebuilds its block sums and total), the coding, and the update
(shared-memory atomics, whose sum does not depend on the lanes' order).

U (second round) is two passes, since the model never reads the coder:
the model pass (one CTA: each lane's next symbol loaded a step ahead, its
prefix summed by trees, from 64 lanes on t0's prefix sums scanned once a
step by one warp in place of atomics on its block sums and total) writes
each lane's blended (c, f, tot), and the coder pass (a thread a lane over
the card) codes them into rc_common's events.
The two alternate over chunks of steps, so that the triples stay within
TRIPLE_BYTES whatever the input, each chunk's coder pass on a side stream
beside the next chunk's model pass; the model and the lanes' coder state
wait in global memory between chunks. `model_triples` and `coder_events`
run one pass alone, over every step. V (second round) runs the model's
phases with the coding in its step: its symbol found by counts of compares
(prefix trees, not a chain), each lane's next word loaded a refill ahead;
past 1,024 lanes its coder state waits in global scratch between a
thread's turns and its atomics are grouped a warp by `__match_any_sync`.

Their plain versions are `o1_ops.encode_events_plain` (the composition of
`model_triples_plain` and `coder_events_plain`, over the same chunks) and
`o1_ops.decode_symbols_plain`. On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises. Both take
every power of two up to 65,536 lanes. A step whose t = range / tot_eff is
0 (fault P6: tot_eff formed in 64 bits, above the range) sets a flag of the
call, its first (step, lane); the wrapper reads the flag once after the
call and raises ValueError on encode, CorruptContainerError on decode
(`o1_ops.step_error`), as the plain versions do. The kernels' counts are
u32: at limit_log2 >= 32 they take a stream only where no total can reach
2^32 (`o1_ops.card_counts_fit`; else `o1_ops.CardCountsError`, a
NotImplementedError: the container is valid, fault P7).
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import layout, o1_ops

encode_launches = 0   # kernel U
decode_launches = 0   # kernel V

MAX_LANES = 1 << 16
CTA_LANES = 1024      # lanes a CTA codes one a thread; more take turns
# kernel U's triples (12 bytes a lane a step, two buffers) stay within this
# many bytes: its passes alternate over chunks of steps, a chunk's coder
# pass beside the next chunk's model pass; a stream is cut into PIPE_CHUNKS
# chunks of at least PIPE_MIN_STEPS steps, fewer steps where the cap says
TRIPLE_BYTES = 64 << 20
PIPE_CHUNKS = 8
PIPE_MIN_STEPS = 256
# the model's words in shared memory (csrc/o1_model.cuh MODEL_WORDS), and
# t1's where it is kept there: U keeps them in global memory between chunks
MODEL_WORDS = 256 * 16 + 256 + 256 + 16 + 4 + 256
T1_NARROW_WORDS = 256 * 128


def _check(name, t, dtype, lane_len, params, n, decode=False):
    """Shapes and parameters; n the bytes coded (at most L*K), for the
    step-0 check."""
    layout.check_lanes(name, t, dtype, lane_len, MAX_LANES)
    k = t.shape[1]
    if k & (k - 1) or k > MAX_LANES:
        raise ValueError(f"kernels U and V take a power of two up to "
                         f"{MAX_LANES} lanes, got {k}")
    o1_ops.check_params(n, *params, decode=decode)


def _check_card(steps: int, k: int, params):
    if not o1_ops.card_counts_fit(steps, k, *params[:3]):
        raise o1_ops.CardCountsError(
            f"kernels U and V keep u32 counts: at limit1_log2={params[1]}, "
            f"limit0_log2={params[2]} a total of {steps} steps of {k} lanes "
            f"at inc {params[0]} may reach 2^32")


def _flag(dev):
    """The flag a call's kernels set at a step with t = 0: all ones."""
    return torch.full((1,), -1, dtype=torch.int64, device=dev)


def _raise_flagged(flag, decode: bool):
    """Raise the step error the flag holds, if any (one host read)."""
    v = int(flag.item()) & (1 << 64) - 1
    if v != (1 << 64) - 1:
        raise o1_ops.step_error(v >> 32, v & 0xFFFFFFFF, decode)


def _t1(wide: bool, dev):
    """-> t1 in global memory where its counts can reach 2^16, else
    None."""
    return torch.empty(256 * 256, dtype=torch.int32, device=dev) \
        if wide else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def default_chunk_steps(k: int, steps: int) -> int:
    """Kernel U's steps a chunk by default: a stream in PIPE_CHUNKS
    chunks of at least PIPE_MIN_STEPS steps, within TRIPLE_BYTES for two
    buffers of triples."""
    pipe = max(PIPE_MIN_STEPS, -(-steps // PIPE_CHUNKS))
    return max(1, min(steps, pipe, TRIPLE_BYTES // (2 * 12 * k)))




def encode_events(x2d: torch.Tensor, lane_len: torch.Tensor, inc: int,
                  limit1_log2: int, limit0_log2: int, blend_log2: int,
                  chunk_steps: int | None = None) -> torch.Tensor:
    """x2d [L, K] uint8 (chunked lanes: x2d[j, i] = x[i*L + j]) -> events
    [3*L + 2, K] int32 (u32 bits, rc_common's format): the model pass and
    the coder pass over chunks of chunk_steps steps (by default
    `default_chunk_steps(K, L)`)."""
    global encode_launches
    params = (inc, limit1_log2, limit0_log2, blend_log2)
    steps, k = x2d.shape
    _check("x2d", x2d, torch.uint8, lane_len, params, steps * k)
    chunk = chunk_steps or default_chunk_steps(k, steps)
    if chunk < 1:
        raise ValueError(f"chunk_steps={chunk_steps} is not a step count")
    if x2d.device.type == "cpu":
        return o1_ops.encode_events_plain(x2d, lane_len, *params,
                                          chunk_steps=chunk)
    chunk = min(chunk, max(steps, 1))
    _check_card(steps, k, params)
    dev = x2d.device
    wide = o1_ops.table_wide(k, inc, limit1_log2)
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((o1_ops.N_SLOTS * steps + 2, k), dtype=torch.int32,
                         device=dev)
        t1 = _t1(wide, dev)
        st = torch.empty(5 * k, dtype=torch.int32, device=dev)
        trip = torch.empty((2 if chunk < steps else 1, chunk, 3, k),
                           dtype=torch.int32, device=dev)
        # the model between chunks: its shared-memory words, with t1 where
        # it is kept there
        mstate = torch.empty(MODEL_WORDS + (0 if wide else T1_NARROW_WORDS),
                             dtype=torch.int32, device=dev) \
            if chunk < steps else None
        flag = _flag(dev)
        rc = lib.ct_o1_encode(
            x2d.data_ptr(), lane_len.data_ptr(), ev.data_ptr(), _ptr(t1),
            st.data_ptr(), trip.data_ptr(), _ptr(mstate), flag.data_ptr(), k,
            steps, chunk, *params, int(wide),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_o1_encode")
    encode_launches += 1
    _raise_flagged(flag, decode=False)
    return ev


def model_triples(x2d: torch.Tensor, lane_len: torch.Tensor, inc: int,
                  limit1_log2: int, limit0_log2: int,
                  blend_log2: int) -> torch.Tensor:
    """Kernel U's model pass alone, over all L steps (no cap: for tests):
    x2d [L, K] uint8 -> triples [L, 3, K] int32, each lane's blended (c,
    f, tot), 0 where it has ended, (0, 0, 2^32 - 1) where tot passes
    2^32 - 1."""
    global encode_launches
    params = (inc, limit1_log2, limit0_log2, blend_log2)
    steps, k = x2d.shape
    _check("x2d", x2d, torch.uint8, lane_len, params, steps * k)
    if x2d.device.type == "cpu":
        return o1_ops.model_triples_plain(x2d, lane_len, *params)[0]
    _check_card(steps, k, params)
    dev = x2d.device
    wide = o1_ops.table_wide(k, inc, limit1_log2)
    lib = build.load()
    with torch.cuda.device(dev):
        trip = torch.empty((steps, 3, k), dtype=torch.int32, device=dev)
        if steps:
            t1 = _t1(wide, dev)
            rc = lib.ct_o1_model(
                x2d.data_ptr(), lane_len.data_ptr(), trip.data_ptr(),
                _ptr(t1), None, k, steps, 0, steps, *params, int(wide),
                torch.cuda.current_stream(dev).cuda_stream)
            build.check(rc, "ct_o1_model")
            encode_launches += 1
    return trip


def coder_events(triples: torch.Tensor) -> torch.Tensor:
    """Kernel U's coder pass alone, over all steps: triples [L, 3, K] int32
    -> events [3*L + 2, K] int32 (u32 bits)."""
    global encode_launches
    if triples.dtype != torch.int32 or triples.dim() != 3 \
            or triples.shape[1] != 3 or not triples.is_contiguous():
        raise ValueError(f"triples must be contiguous int32 [L, 3, K], got "
                         f"{triples.dtype} {tuple(triples.shape)}")
    steps, _, k = triples.shape
    if k < 1 or k & (k - 1) or k > MAX_LANES:
        raise ValueError(f"kernel U takes a power of two up to {MAX_LANES} "
                         f"lanes, got {k}")
    if triples.device.type == "cpu":
        return o1_ops.coder_events_plain(triples)[0]
    dev = triples.device
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((o1_ops.N_SLOTS * steps + 2, k), dtype=torch.int32,
                         device=dev)
        flag = _flag(dev)
        rc = lib.ct_o1_coder(triples.data_ptr(), ev.data_ptr(), None,
                             flag.data_ptr(), k, steps, 0, steps,
                             torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_o1_coder")
    encode_launches += 1
    _raise_flagged(flag, decode=False)
    return ev


def decode_symbols(words: torch.Tensor, lane_len: torch.Tensor, n: int,
                   steps: int, inc: int, limit1_log2: int, limit0_log2: int,
                   blend_log2: int) -> torch.Tensor:
    """words [l4, K] int32 big-endian u32 word rows (word-major, l4 >= 1)
    -> the n decoded bytes, uint8 [n] (byte i*L + j is lane i's step j,
    L = steps)."""
    global decode_launches
    params = (inc, limit1_log2, limit0_log2, blend_log2)
    _check("words", words, torch.int32, lane_len, params, n, decode=True)
    l4, k = words.shape
    if l4 < 1 or not 0 <= n <= k * steps:
        raise ValueError(f"n={n} does not fit {k} lanes of {steps} steps, "
                         f"or no word rows ({l4})")
    if words.device.type == "cpu":
        return o1_ops.decode_symbols_plain(words, lane_len, n, steps, *params)
    _check_card(steps, k, params)
    dev = words.device
    wide = o1_ops.table_wide(k, inc, limit1_log2)
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        t1 = _t1(wide, dev)
        # past CTA_LANES the lanes' coder state between a thread's turns
        st = torch.empty(7 * k, dtype=torch.int32, device=dev) \
            if k > CTA_LANES else None
        flag = _flag(dev)
        rc = lib.ct_o1_decode(
            words.data_ptr(), lane_len.data_ptr(), out.data_ptr(), _ptr(t1),
            _ptr(st), flag.data_ptr(), k, l4, steps, *params, int(wide),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_o1_decode")
    decode_launches += 1
    _raise_flagged(flag, decode=True)
    return out
