"""CT-RC3 container path in PyTorch (counterpart of
cpprcoder_tpu/ops/o1_ops.py).

Format: reference/o1_ref.py. K chunked lanes: lane i codes x[i*L + j] at
step j < lens[i], with L = ceil(n/K) and lens[i] = clip(n - i*L, 0, L)
(layout.pad2d_chunked / layout.lane_lengths). All lanes share one model: an
order-1 table t1[256][256] with its row totals rowtot[256], and an order-0
table t0[256] with its total tot0, all counts starting at 1. Before each
step, every row whose total has reached 2^limit1_log2 becomes
(f >> 1) | 1, and so does t0 once tot0 has reached 2^limit0_log2. A lane
whose context is ctx (its previous byte, 0 at its first step) codes s
against the blend, A = 2^blend_log2:

    f_eff = A*t1[ctx][s] + t0[s],  c_eff = A*C1[ctx][s] + C0[s],
    tot_eff = A*rowtot[ctx] + tot0

(C the exclusive cumulative sums), with t = range / tot_eff, a real divide
(tot_eff differs by lane and by step). After the step every active lane
adds inc to t1[ctx][s], rowtot[ctx] and t0[s], and tot0 grows by inc for
each; the sum does not depend on the lanes' order.

The coder is kernel U (encode, ops/o1_kernels.py) and kernel V (decode).
U's events are rc_common's format with N_SLOTS = 3 a step, time-major
[3*L + 2, K] (two flush rows), and become the lanes' payload rows through
kernel B (ops/expand.py), where the JAX package expands them with XLA. V
reads each lane's big-endian word row through a byte queue that takes a
whole word whenever fewer than 3 bytes are buffered (bytes past the lane's
end read as zero), as CT-RC2's decoder does. `encode_events_plain` and
`decode_symbols_plain` are the kernels' plain versions: step loops over
int64 lane vectors that read the model's rows by index. Kernel U is two
passes, and so is its plain version: `model_triples_plain` (the model:
each lane's blended (c, f, tot) a step) and `coder_events_plain` (the
range coder over those triples), alternating over chunks of steps.

The parameters and the steps (ROADMAP C8, fault P6). Each of inc and the
three log2s must fit the header's byte. Nothing else is refused from the
parameters alone but blend_log2 >= 24 where n >= 1: at step 0 every count
is 1, so tot_eff = 2^blend_log2 * 256 + 256 > 2^32 - 1 >= range and
t = range / tot_eff = 0 there (`check_params`; n = 0 codes no step and
writes the 9-byte header at any parameters). Every other step is checked
where t is formed: tot_eff is computed in 64 bits, and a step whose t is 0
(tot_eff above the range, which is below 2^32) raises ValueError on encode
and CorruptContainerError on decode. The oracle never ends on such a step,
so it writes no such container.

Claim: where t >= 1 at every step, 3 slots a step suffice and the coder
ends. Proof. With t >= 1 and c_eff + f_eff <= tot_eff, the step leaves
range >= t*f_eff >= 1 (the top symbol keeps range - t*c_eff >= t*f_eff
too); three shifts of 8 bits bring a range >= 1 to 2^24 or more, and a
range below 2^24 shifted by 8 stays below 2^32. So every step ends within
its 3 slots, and the flush ends the stream.

C8's bound stays a fact that gates nothing: no step codes against a
tot_eff above `model_bound` = 2^blend_log2 * B1 + B0, B1 = max(2^limit1_log2
- 1, K*inc + 512) and B0 likewise for limit0_log2. range_ops.total_bound's
induction holds for each row of t1 on its own: a row's total is 256 <= B1
at step 0; before step j + 1 it is P = T + a*inc with T <= B1 its total at
step j and a <= K the lanes that coded in this context; if P < 2^limit1 it
is kept and P <= B1, else every count f becomes (f >> 1) | 1 <= f/2 + 1 and
the total is at most P/2 + 256 <= (B1 + K*inc)/2 + 256 <= B1. The same
induction bounds tot0 by B0. Within 2^24, t >= 1 at every step.

The counts the kernels store: a count never exceeds its row's total
before a rescale, P <= B1 + K*inc, so t1 fits u16 where B1 + K*inc < 2^16
(`table_wide` false: kernel U and V keep t1 in shared memory as u16
pairs), else the kernels keep t1 as u32 in global memory. The kernels'
counts and totals are u32: at limit_log2 <= 31 every total stays below
2^31 + 2^24 (B + K*inc), and at limit_log2 >= 32 the wrappers take only
streams where 256 + inc*L*K < 2^32 - 1, so that no total reaches 2^32 - 1,
the kernels' limit there (`card_counts_fit`; else CardCountsError, on
encode and decode alike); the plain versions' int64 counts take every
stream.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.config import MASK32, RC_TOP, pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import (
    ByteReader,
    ByteWriter,
    CorruptContainerError,
    as_u8,
)
from cpprcoder_tpu_torch.ops import layout, rc_common
from cpprcoder_tpu_torch.ops.range_ops import total_bound
from cpprcoder_tpu_torch.reference.o1_ref import (
    BLEND_LOG2,
    LIMIT0_LOG2,
    LIMIT1_LOG2,
    pick_inc,
)
from cpprcoder_tpu_torch.reference.rc_ref import _lane_desc, _parse_lane_desc

N_SLOTS = 3           # shift_low slots a step (3: tot_eff may pass 2^16)
TOTAL_LIMIT = 1 << 24  # C8: no tot_eff within 2^24 gives t = 0
BLEND_LOG2_STEP0 = 24  # from here t = 0 at step 0 (tot_eff > 2^32 - 1)
LIMIT_LOG2_NEVER = 62  # no int64 count reaches 2^62: the rescale never fires


def model_bound(k: int, inc: int, limit1_log2: int, limit0_log2: int,
                blend_log2: int) -> int:
    """2^blend_log2 * B1 + B0: no step of K lanes codes against a larger
    tot_eff (the proof is in the module's docstring)."""
    return (total_bound(k, inc, limit1_log2) << blend_log2) \
        + total_bound(k, inc, limit0_log2)


def check_params(n: int, inc: int, limit1_log2: int, limit0_log2: int,
                 blend_log2: int, decode: bool = False) -> None:
    """Raise ValueError unless the parameters fit the header's bytes and,
    where n >= 1, step 0 has t >= 1 (blend_log2 < 24; else
    CorruptContainerError where `decode`). Later steps are checked where t
    is formed."""
    for name, v in (("inc", inc), ("limit1_log2", limit1_log2),
                    ("limit0_log2", limit0_log2), ("blend_log2", blend_log2)):
        if not 0 <= v < 256:
            raise ValueError(f"{name}={v} does not fit the header's byte")
    if n and blend_log2 >= BLEND_LOG2_STEP0:
        msg = (f"CT-RC3 at blend_log2={blend_log2}: step 0 codes against "
               f"tot_eff = 2^{blend_log2}*256 + 256 > 2^32 - 1, so range / "
               f"tot_eff = 0 and the coder does not end")
        raise CorruptContainerError(msg) if decode else ValueError(msg)


class CardCountsError(NotImplementedError):
    """Kernels U and V refuse a valid stream whose u32 counts could reach
    2^32 (`card_counts_fit` false): a limit of the card's kernels (fault
    P7), not a fault of the input, which the CPU path encodes and
    decodes."""


def card_counts_fit(steps: int, k: int, inc: int, limit1_log2: int,
                    limit0_log2: int) -> bool:
    """Whether kernels U and V's u32 counts and totals stay below 2^32 - 1
    (their limit where the header's is 2^32 or more): always at limit_log2
    <= 31 (the module's docstring), else where 256 plus inc for each of the
    L*K positions stays below 2^32 - 1."""
    return max(limit1_log2, limit0_log2) < 32 \
        or 256 + inc * steps * k < (1 << 32) - 1


def step_error(step: int, lane: int, decode: bool) -> ValueError:
    """The error for a step whose t = range / tot_eff is 0."""
    msg = (f"CT-RC3 step {step}, lane {lane}: range / tot_eff = 0 (tot_eff "
           f"above the range), where the coder does not end")
    return CorruptContainerError(msg) if decode else ValueError(msg)


def table_wide(k: int, inc: int, limit1_log2: int) -> bool:
    """Whether a t1 count can reach 2^16 (B1 + K*inc >= 2^16): the kernels
    then keep t1 as u32 in global memory, else as u16 in shared memory."""
    return total_bound(k, inc, limit1_log2) + k * inc >= 1 << 16


def _rescale(t1, rowtot, t0, tot0, limit1: int, limit0: int) -> int:
    """The model before a step, in place: rows whose total reached limit1
    halve as (f >> 1) | 1, t0 too once tot0 reached limit0. -> the rows
    halved (read on the host: the loop below runs no halving it does not
    need)."""
    rows = torch.nonzero(rowtot >= limit1).squeeze(1)
    if rows.numel():
        t1[rows] = (t1[rows] >> 1) | 1
        rowtot[rows] = t1[rows].sum(dim=1)
    r0 = tot0 >= limit0
    t0.copy_(torch.where(r0, (t0 >> 1) | 1, t0))
    tot0.copy_(torch.where(r0, t0.sum(), tot0))
    return rows.numel()


def _init_model(dev):
    return (torch.ones((256, 256), dtype=torch.int64, device=dev),
            torch.full((256,), 256, dtype=torch.int64, device=dev),
            torch.ones(256, dtype=torch.int64, device=dev),
            torch.tensor(256, dtype=torch.int64, device=dev))


def _update(t1, rowtot, t0, tot0, ctx, sym, active, inc: int):
    """Every active lane adds inc to t1[ctx][s], rowtot[ctx], t0[s] and
    tot0, in place."""
    w = torch.where(active, inc, 0)
    t1.index_put_((ctx, sym), w, accumulate=True)
    rowtot.index_add_(0, ctx, w)
    t0.index_add_(0, sym, w)
    tot0.add_(w.sum())


def model_triples_plain(x2d: torch.Tensor, lane_len: torch.Tensor, inc: int,
                        limit1_log2: int, limit0_log2: int, blend_log2: int,
                        j0: int = 0, j1: int | None = None, model=None,
                        stats: dict | None = None):
    """Plain version of kernel U's model pass over steps [j0, j1) (j1
    defaults to L): x2d [L, K] uint8 (chunked: x2d[j, i] = x[i*L + j]) ->
    (triples [j1 - j0, 3, K] int32: each lane's blended (c, f, tot), 0
    where it has ended, and (0, 0, 2^32 - 1) where tot_eff passes 2^32 - 1:
    t = 0 there, which the coder pass reports; the model after step j1 - 1,
    to pass on as `model` for the steps from j1). Lane i codes x2d[j, i] for
    j < lane_len[i]. stats, if given, gets "rows_halved" added: the t1 rows
    rescaled."""
    steps, k = x2d.shape
    j1 = steps if j1 is None else j1
    dev = x2d.device
    limit1 = 1 << min(limit1_log2, LIMIT_LOG2_NEVER)
    limit0 = 1 << min(limit0_log2, LIMIT_LOG2_NEVER)
    t1, rowtot, t0, tot0 = model if model is not None else _init_model(dev)
    xs = x2d.to(torch.int64)
    lens = lane_len.to(torch.int64)
    ctx = xs[j0 - 1] if j0 > 0 else torch.zeros(k, dtype=torch.int64,
                                                 device=dev)
    lane = torch.arange(k, device=dev)
    out = torch.zeros((j1 - j0, 3, k), dtype=torch.int64, device=dev)
    halved = 0
    for j in range(j0, j1):
        halved += _rescale(t1, rowtot, t0, tot0, limit1, limit0)
        active = j < lens
        sym = xs[j]
        rows = t1[ctx]
        c1 = torch.cumsum(rows, dim=1) - rows
        c0 = torch.cumsum(t0, 0) - t0
        f = (rows[lane, sym] << blend_log2) + t0[sym]
        c = (c1[lane, sym] << blend_log2) + c0[sym]
        tot = (rowtot[ctx] << blend_log2) + tot0
        over = tot > MASK32
        trip = torch.stack([torch.where(over, 0, c), torch.where(over, 0, f),
                            torch.where(over, MASK32, tot)])
        out[j - j0] = torch.where(active, trip, 0)
        _update(t1, rowtot, t0, tot0, ctx, sym, active, inc)
        ctx = torch.where(active, sym, ctx)
    if stats is not None:
        stats["rows_halved"] = stats.get("rows_halved", 0) + halved
    return rc_common.u32_to_i32(out), (t1, rowtot, t0, tot0)


def coder_events_plain(triples: torch.Tensor, state=None, final: bool = True,
                       j0: int = 0):
    """Plain version of kernel U's coder pass: triples [n, 3, K] int32 (the
    model pass's; tot 0 where a lane has ended) -> (events [3*n (+ 2 where
    final), K] int32 (u32 bits, rc_common's format: 3 slots a step, then
    the two flush rows where final); the lanes' coder state, to pass on
    as `state` for the next steps). Raises ValueError naming the first
    step (j0 + its index) and lane whose t = range / tot_eff is 0, or
    whose f is 0 (the model pass's mark of a tot_eff past 2^32 - 1)."""
    n, _, k = triples.shape
    dev = triples.device
    st = state if state is not None else rc_common.make_state(k, dev)
    trip = rc_common.i32_to_u32(triples)
    events = torch.empty((N_SLOTS * n + (2 if final else 0), k),
                         dtype=torch.int64, device=dev)
    bad = torch.zeros((n, k), dtype=torch.bool, device=dev)
    for j in range(n):
        c, f, tot = trip[j]
        active = tot > 0
        t = st[2] // torch.clamp(tot, min=1)
        bad[j] = active & ((t == 0) | (f == 0))
        st, evs = rc_common.encode_symbol(st, t, c, f, (c + f) == tot, active,
                                          N_SLOTS)
        events[N_SLOTS * j:N_SLOTS * (j + 1)] = evs
    if final:
        events[N_SLOTS * n:] = rc_common.flush(st)
    at = torch.nonzero(bad)
    if at.numel():
        raise step_error(j0 + int(at[0, 0]), int(at[0, 1]), decode=False)
    return rc_common.u32_to_i32(events), st


def encode_events_plain(x2d: torch.Tensor, lane_len: torch.Tensor, inc: int,
                        limit1_log2: int, limit0_log2: int, blend_log2: int,
                        stats: dict | None = None,
                        chunk_steps: int | None = None) -> torch.Tensor:
    """Plain version of kernel U: x2d [L, K] uint8 -> events [3*L + 2, K]
    int32 (u32 bits), the model pass and the coder pass alternating over
    chunks of chunk_steps steps (all L steps by default) as the kernel's
    do; the events do not depend on the chunks. stats as for
    model_triples_plain."""
    steps = x2d.shape[0]
    chunk = chunk_steps or max(steps, 1)
    params = (inc, limit1_log2, limit0_log2, blend_log2)
    model = state = None
    parts = []
    j0 = 0
    while True:
        j1 = min(steps, j0 + chunk)
        trip, model = model_triples_plain(x2d, lane_len, *params, j0=j0, j1=j1,
                                          model=model, stats=stats)
        ev, state = coder_events_plain(trip, state, final=j1 == steps, j0=j0)
        parts.append(ev)
        j0 = j1
        if j0 >= steps:
            return torch.cat(parts)


def decode_symbols_plain(words: torch.Tensor, lane_len: torch.Tensor, n: int,
                         steps: int, inc: int, limit1_log2: int,
                         limit0_log2: int, blend_log2: int) -> torch.Tensor:
    """Plain version of kernel V: words [l4, K] int32 big-endian u32 word
    rows (word-major, l4 >= 1) -> the n decoded bytes, uint8 [n] (byte
    i*L + j is lane i's step j, L = steps). The symbol is the number of
    blended inclusive cumulative counts at or below min(code / t,
    tot_eff - 1). Raises CorruptContainerError naming the first step and
    lane whose t = range / tot_eff is 0."""
    l4, k = words.shape
    dev = words.device
    limit1 = 1 << min(limit1_log2, LIMIT_LOG2_NEVER)
    limit0 = 1 << min(limit0_log2, LIMIT_LOG2_NEVER)
    bad = torch.zeros((steps, k), dtype=torch.bool, device=dev)
    t1, rowtot, t0, tot0 = _init_model(dev)
    w = rc_common.i32_to_u32(words)
    zero = torch.zeros(k, dtype=torch.int64, device=dev)
    rng = torch.full((k,), MASK32, dtype=torch.int64, device=dev)
    code = w[0]
    q = zero.clone()      # the queued bytes, the oldest highest
    occ = zero.clone()    # how many
    widx = torch.ones_like(zero)
    lens = lane_len.to(torch.int64)
    ctx = zero.clone()
    lane = torch.arange(k, device=dev)
    out = torch.zeros((steps, k), dtype=torch.uint8, device=dev)
    for j in range(steps):
        _rescale(t1, rowtot, t0, tot0, limit1, limit0)
        active = j < lens
        need = active & (occ < N_SLOTS)
        word = torch.where(widx < l4, w[torch.clamp(widx, max=l4 - 1), lane],
                           0)
        q = torch.where(need, (q << 32) | word, q)
        occ = torch.where(need, occ + 4, occ)
        widx = torch.where(need, widx + 1, widx)
        incl = (torch.cumsum(t1[ctx], dim=1) << blend_log2) \
            + torch.cumsum(t0, 0)[None, :]
        tot = (rowtot[ctx] << blend_log2) + tot0
        t = rng // tot
        bad[j] = active & (t == 0)
        t = torch.clamp(t, min=1)   # past a step with t = 0 nothing counts
        v = torch.minimum(code // t, tot - 1)
        sym = torch.clamp((incl <= v[:, None]).sum(dim=1), max=255)
        c = torch.where(sym > 0, incl[lane, torch.clamp(sym - 1, min=0)], 0)
        f = incl[lane, sym] - c
        code2 = code - t * c
        rng2 = torch.where((c + f) == tot, rng - t * c, t * f)
        occ2 = occ
        for _ in range(N_SLOTS):
            do = rng2 < RC_TOP
            occ2 = occ2 - do.to(torch.int64)
            byte = (q >> (8 * torch.clamp(occ2, min=0))) & 0xFF
            code2 = torch.where(do, ((code2 << 8) | byte) & MASK32, code2)
            rng2 = torch.where(do, (rng2 << 8) & MASK32, rng2)
        q2 = q & (torch.bitwise_left_shift(torch.ones_like(occ2), 8 * occ2) - 1)
        rng, code, q, occ = (torch.where(active, a, b) for a, b in
                             ((rng2, rng), (code2 & MASK32, code), (q2, q),
                              (occ2, occ)))
        out[j] = torch.where(active, sym, 0).to(torch.uint8)
        _update(t1, rowtot, t0, tot0, ctx, sym, active, inc)
        ctx = torch.where(active, sym, ctx)
    at = torch.nonzero(bad)
    if at.numel():
        raise step_error(int(at[0, 0]), int(at[0, 1]), decode=True)
    return out.T.reshape(-1)[:n]


# ------------------------------------------------------------ containers

def header(n: int, k: int, wide: bool, inc: int, limit1_log2: int,
           limit0_log2: int, blend_log2: int) -> ByteWriter:
    """CT-RC3 header: u32 n, lane_desc(K, wide), inc, limit1_log2,
    limit0_log2, blend_log2."""
    return (ByteWriter().u32(n).u8(_lane_desc(k, wide)).u8(inc)
            .u8(limit1_log2).u8(limit0_log2).u8(blend_log2))


def o1_encode(data, lanes: int | None = None, inc: int | None = None,
              limit1_log2: int = LIMIT1_LOG2, limit0_log2: int = LIMIT0_LOG2,
              blend_log2: int = BLEND_LOG2, *, device) -> bytes:
    """CT-RC3 container of `data`, coded on `device` (kernels U and B on
    CUDA, their plain versions on the CPU). Same parameters as
    o1_ref.o1_encode; raises ValueError at a step whose t = range / tot_eff
    is 0, where the oracle does not end."""
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    inc = inc if inc is not None else pick_inc(k)
    params = (inc, limit1_log2, limit0_log2, blend_log2)
    check_params(n, *params)
    if n == 0:
        return header(0, k, False, *params).getvalue()
    from cpprcoder_tpu_torch.ops import expand, o1_kernels

    steps = -(-n // k)
    # a lane's pending run of 0xFF bytes must fit the event's 22-bit field
    if N_SLOTS * steps + 2 >= 1 << rc_common.EV_RUN_BITS:
        raise ValueError(f"{n} bytes over {k} lanes exceed one container "
                         f"({steps} steps a lane); split the input")
    xt = torch.from_numpy(x.copy()).to(device)
    events = o1_kernels.encode_events(
        layout.pad2d_chunked(xt, k, steps),
        layout.lane_lengths(n, k, steps, xt.device), *params)
    rows, sizes = expand.materialize_rows(events)
    return layout.assemble(lambda wide: header(n, k, wide, *params),
                           rows.cpu().numpy(), sizes.cpu().numpy())


def o1_decode(blob, *, device) -> bytes:
    """CT-RC3 container -> its bytes, decoded on `device` (kernel V on CUDA,
    its plain version on the CPU). Raises CorruptContainerError where a
    step's t = range / tot_eff is 0 (step 0 at blend_log2 >= 24)."""
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    params = (r.u8(), r.u8(), r.u8(), r.u8())
    check_params(n, *params, decode=True)
    if n == 0:
        return b""
    from cpprcoder_tpu_torch.ops import o1_kernels

    steps = -(-n // k)
    words = layout.payload_words(r, k, wide, device)
    out = o1_kernels.decode_symbols(
        words, layout.lane_lengths(n, k, steps, words.device), n, steps,
        *params)
    return out.cpu().numpy().tobytes()

