"""CT-RC2's slot rule (`range_ops.slots`: 2 shift_low slots a step only
where the coding total provably stays at or below 2^16) and the lane widths
up to 65,536, on the CPU, held to the numpy oracle with exact equality
(integer codec: tolerance 0).

The JAX package keeps the old rule (2 slots whenever limit_log2 <= 16,
ROADMAP C6), so at K*inc + 512 > 2^16 the port is held to the oracle
alone. A numpy model of kernels J's and L's arithmetic (the table built from
row histograms and a count of active lanes, the total tracked by adds and
halvings, range / total by a multiply-high and one correction, the symbol
as the largest s with t*cum[s] <= code, found from pivots) is held against
the oracle and the plain step loops, so that a change of the kernels'
algorithm shows here first.
"""

import numpy as np
import pytest
import torch

from conftest import corpus_file

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu_torch.core.bytesutil import ByteReader
from cpprcoder_tpu_torch.ops import (
    expand,
    layout,
    range_kernels,
    range_ops,
    rc_common,
)
from cpprcoder_tpu_torch.reference import rc_ref as tref

MASK32 = (1 << 32) - 1


def _zipf(n, seed):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(1.3, n) - 1, 255).astype(np.uint8)


# ------------------------------------------- the slot rule

WIDE_TOTAL_CASES = {
    "grammar.lsp lanes 512": (lambda: corpus_file("grammar.lsp"), 512),
    "grammar.lsp lanes 1024": (lambda: corpus_file("grammar.lsp"), 1024),
    "alice29.txt[:30000] lanes 1024":
        (lambda: corpus_file("alice29.txt")[:30000], 1024),
}


@pytest.mark.parametrize("case", list(WIDE_TOTAL_CASES))
def test_totals_past_2_16_write_and_read_the_oracles_bytes(case):
    """inc 255 at limit_log2 16: the total passes 2^16, so a step takes
    three slots. The port's container equals the oracle's, and the port
    decodes the oracle's container."""
    make, lanes = WIDE_TOTAL_CASES[case]
    data = make()
    opts = dict(lanes=lanes, inc=255, limit_log2=16)
    assert range_ops.slots(None, 16, lanes, 255) == 3
    # the total the oracle codes against does pass 2^16
    assert max(_totals(np.frombuffer(data, np.uint8), lanes, 255, 16)) \
        > 1 << 16
    want = tref.adaptive_encode(data, **opts)
    assert ctt.compress(data, codec="adaptive_range", device="cpu",
                        **opts) == want
    assert ctt.decompress(want, codec="adaptive_range", device="cpu") == data


@pytest.mark.parametrize("static,k,inc,limit_log2,want", [
    (True, 65536, 0, 16, 2),
    (False, 256, 24, 16, 2),      # the defaults at K = 256
    (False, 1024, 24, 17, 3),     # the defaults at K = 1,024
    (False, 128, 255, 16, 2),     # 128*255 + 512 = 33,152
    (False, 256, 255, 16, 3),     # 256*255 + 512 = 65,792 > 2^16
    (False, 1024, 255, 16, 3),
    (False, 1, 0, 16, 2),         # 2^16 - 1
    (False, 1, 0, 17, 3),         # 2^17 - 1
    (False, 65536, 0, 8, 2),      # 512
    (False, 65536, 1, 8, 3),      # 66,048
])
def test_slots_follow_the_bound(static, k, inc, limit_log2, want):
    freqs = np.ones(256) if static else None
    assert range_ops.slots(freqs, limit_log2, k, inc) == want


def _totals(x: np.ndarray, k: int, inc: int, limit_log2: int) -> list[int]:
    """The total each step of the oracle's CT-RC2 codes against."""
    freqs = np.ones(256, dtype=np.int64)
    total, out = 256, []
    for base in range(0, len(x), k):
        if total >= 1 << limit_log2:
            freqs = (freqs >> 1) | 1
            total = int(freqs.sum())
        out.append(total)
        row = x[base:base + k]
        freqs += np.bincount(row, minlength=256) * inc
        total += len(row) * inc
    return out


@pytest.mark.parametrize("seed", range(10))
def test_total_never_exceeds_the_bound(seed):
    """Over random (K, inc, limit_log2, data), the coding total stays at or
    below total_bound, the bound `slots` uses (30 cases a seed)."""
    rng = np.random.default_rng(seed)
    for _ in range(30):
        k = 1 << int(rng.integers(0, 12))
        inc = int(rng.integers(0, 256))
        limit_log2 = int(rng.integers(8, 21))
        steps = int(rng.integers(1, 60))
        kind = int(rng.integers(0, 3))
        n = k * steps - int(rng.integers(0, k))
        x = (_zipf(n, seed) if kind == 0 else
             np.full(n, int(rng.integers(0, 256)), np.uint8) if kind == 1 else
             rng.integers(0, 256, n, dtype=np.uint8))
        bound = range_ops.total_bound(k, inc, limit_log2)
        tot = _totals(x, k, inc, limit_log2)
        assert max(tot) <= bound, (k, inc, limit_log2)


# ------------------------------------ the widest lane counts

FIELDS_BYTES = {("static_range", 16384): 50193, ("static_range", 32768): 99345,
                ("static_range", 65536): 197649,
                ("adaptive_range", 16384): 60309,
                ("adaptive_range", 32768): 109461,
                ("adaptive_range", 65536): 207765}


@pytest.mark.parametrize("codec,lanes", list(FIELDS_BYTES))
def test_widest_lane_counts_match_the_oracle(codec, lanes):
    """fields.c at 16,384 to 65,536 lanes (the widest lane descriptor):
    the oracle's sizes and bytes, and a round trip."""
    data = corpus_file("fields.c")
    blob = ctt.compress(data, codec=codec, device="cpu", lanes=lanes)
    assert len(blob) == FIELDS_BYTES[codec, lanes]
    assert blob == ctt.compress(data, codec=codec, backend="ref",
                                lanes=lanes)
    assert ctt.decompress(blob, codec=codec, device="cpu") == data


def test_wrappers_take_every_power_of_two_to_65536():
    assert range_kernels.MAX_LANES == 1 << 16


# ------------------------------------ a numpy model of kernels J and L

def div_magic(n: np.ndarray, d: int) -> np.ndarray:
    """The kernels' floor(n / d): umulhi(n, floor((2^32 - 1) / d)) plus one
    correction."""
    m = MASK32 // d
    q = (n.astype(np.uint64) * np.uint64(m)) >> np.uint64(32)
    return (q + (n.astype(np.uint64) - q * np.uint64(d) >= d)).astype(np.int64)


@pytest.mark.parametrize("seed", range(4))
def test_division_by_the_magic_number_is_exact(seed):
    rng = np.random.default_rng(seed)
    ds = np.concatenate([[1, 2, 3, 255, 256, 257, 65535, 65536, 65537,
                          (1 << 24) - 1, 1 << 24, MASK32 - 1, MASK32],
                         rng.integers(1, 1 << 32, 200, dtype=np.uint64)])
    for d in ds.astype(np.int64).tolist():
        n = np.concatenate([[0, 1, d - 1, d, d + 1, MASK32 - 1, MASK32,
                             MASK32 - MASK32 % d, MASK32 - MASK32 % d - 1],
                            rng.integers(0, 1 << 32, 300, dtype=np.uint64)])
        n = n.astype(np.int64)
        n = n[(n >= 0) & (n <= MASK32)].astype(np.uint64)
        assert np.array_equal(div_magic(n, d), (n // np.uint64(d)).astype(
            np.int64))


def search(cum: np.ndarray, t: int, code: int, pivots: bool) -> int:
    """Kernel L's CT-RC2 symbol: the largest s in [0, 255] with t*cum[s] <=
    code, by counting the pivots cum[16i] (i = 1..15) at or below, then 4
    halvings in the block of 16, or by 8 halvings."""
    ok = lambda c: t * int(c) <= code  # noqa: E731
    if pivots:
        s = 16 * sum(ok(cum[16 * i]) for i in range(1, 16))
        steps = (8, 4, 2, 1)
    else:
        s, steps = 0, (128, 64, 32, 16, 8, 4, 2, 1)
    for b in steps:
        if ok(cum[s + b]):
            s += b
    return s


@pytest.mark.parametrize("pivots", [True, False])
def test_search_without_a_divide_is_the_references(pivots):
    """Every count >= 1 (CT-RC2): the largest s with t*cum[s] <= code is
    the reference's searchsorted(cum, min(code // t, total - 1)) - 1."""
    rng = np.random.default_rng(int(pivots))
    for _ in range(300):
        kind = int(rng.integers(0, 3))
        f = (rng.integers(1, 3, 256) if kind == 0 else
             np.where(rng.random(256) < 0.05, rng.integers(1, 60000, 256), 1)
             if kind == 1 else rng.integers(1, 1 << 16, 256)).astype(np.int64)
        cum = np.concatenate([[0], np.cumsum(f)])
        total = int(cum[-1])
        rng_ = int(rng.integers(max(total, 1 << 24), 1 << 32))
        t = rng_ // total
        for code in [0, rng_ - 1, t * total - 1, t * total,
                     *rng.integers(0, rng_, 20).tolist()]:
            v = min(code // t, total - 1)
            want = int(np.searchsorted(cum[:256], v, side="right")) - 1
            assert search(cum, t, int(code), pivots) == want


def model_tables(x2d: np.ndarray, lens: np.ndarray, inc: int,
                 limit_log2: int):
    """Kernel J's producers: histogram lane t adds each active byte t +
    32*H*i of a row to copy t & 7 of a cumulative histogram, even rows and
    odd rows apart (u32, never cleared), and the active count to copy 0;
    the table warp adds inc times the growth of the row's histogram since
    it last read it, modulo 2^32, and grows the total by inc times the
    active count's growth (never summed but at a halving). L's warps do the
    same with one copy. -> [(counts, total)] for every step."""
    stride, k = x2d.shape
    h_warps = 1 if k <= 64 else 2 if k <= 128 else 4 if k <= 256 else 8
    copy = (np.arange(k) % (32 * h_warps)) & 7
    start = np.uint32(2**32 - 37)     # the growth wraps past 2^32
    cumh = np.zeros((2, 8, 257), np.uint32)
    cumh[:, 0, :] = start
    seen = np.full((2, 257), start, np.uint32)
    f = np.ones(256, dtype=np.int64)
    total, out = 256, []
    for j in range(stride):
        if j:
            b = (j - 1) & 1
            now = cumh[b].sum(0, dtype=np.uint32)
            now[256] = cumh[b, 0, 256]
            grown = (now - seen[b]).astype(np.int64)   # modulo 2^32
            seen[b] = now
            f += inc * grown[:256]
            total += inc * int(grown[256])
        if total >= 1 << limit_log2:
            f = (f >> 1) | 1
            total = int(f.sum())
        out.append((f.copy(), total))
        on = j < lens
        np.add.at(cumh[j & 1], (copy[on], x2d[j][on].astype(np.int64)), 1)
        cumh[j & 1, 0, 256:] += np.uint32(on.sum())   # wraps modulo 2^32
    return out


@pytest.mark.parametrize("k,inc,limit_log2,ragged", [
    (8, 24, 10, False), (64, 255, 16, True), (256, 24, 16, True),
    (1024, 24, 17, True), (4, 0, 9, False)])
def test_producer_tables_are_the_plain_versions(k, inc, limit_log2, ragged):
    """The tables kernel J's producers publish (and kernel L's warps
    rebuild from their histograms) equal the plain loop's `_step_model`
    tables at every step, lanes of unequal length included, and the
    tracked total is the counts' sum. The histograms start near 2^32, so
    their growth wraps past it, as the kernels' u32 counters may."""
    rng = np.random.default_rng(k)
    stride = 40
    x2d = _zipf(stride * k, k).reshape(stride, k)
    lens = np.full(k, stride)
    if ragged:
        lens = rng.integers(0, stride + 1, k)
    f_tab = torch.ones(256, dtype=torch.int64)
    xs = torch.from_numpy(x2d.astype(np.int64))
    lt = torch.from_numpy(lens)
    for j, (f, total) in enumerate(model_tables(x2d, lens, inc, limit_log2)):
        f_tab, tot, _ = range_ops._step_model(f_tab, 1 << limit_log2)
        assert total == int(tot) == int(f.sum())
        assert np.array_equal(f, f_tab.numpy())
        f_tab = f_tab.index_add(0, xs[j], torch.where(j < lt, inc, 0))


def model_decode(words: np.ndarray, lens: np.ndarray, n: int, inc: int,
                 limit_log2: int, pivots: bool, ahead: int) -> bytes:
    """Kernel L's CT-RC2 decode, step by step: each lane's next `ahead`
    words held early, range / total by div_magic, the search, the byte
    queue; the table of step j + 1 from the counts of step j plus inc
    times the step's histogram and active count."""
    l4, k = words.shape
    stride = -(-n // k)
    n_slots = range_ops.slots(None, limit_log2, k, inc)
    word = lambda i, w: int(words[w, i]) if w < l4 else 0  # noqa: E731
    rng = [MASK32] * k
    code = [word(i, 0) for i in range(k)]
    q, occ, widx = [0] * k, [0] * k, [1] * k
    early = [[word(i, 1 + a) for a in range(ahead)] for i in range(k)]
    f = np.ones(256, dtype=np.int64)
    total = 256
    out = np.zeros((stride, k), np.uint8)
    for j in range(stride):
        if total >= 1 << limit_log2:
            f = (f >> 1) | 1
            total = int(f.sum())
        cum = np.concatenate([[0], np.cumsum(f)])
        hist = np.zeros(256, np.int64)
        act = 0
        for i in range(k):
            if j >= lens[i]:
                continue
            act += 1
            if occ[i] < n_slots:
                if ahead:
                    w = early[i].pop(0)
                    early[i].append(word(i, widx[i] + ahead))
                else:
                    w = word(i, widx[i])
                q[i] = ((q[i] << 32) | w) & ((1 << 64) - 1)
                occ[i] += 4
                widx[i] += 1
            t = int(div_magic(np.array([rng[i]], np.uint64), total)[0])
            s = search(cum, t, code[i], pivots)
            c, fs = int(cum[s]), int(f[s])
            code[i] = (code[i] - t * c) & MASK32
            rng[i] = rng[i] - t * c if c + fs == total else t * fs
            for _ in range(n_slots):
                if rng[i] < 1 << 24:
                    occ[i] -= 1
                    code[i] = ((code[i] << 8) | (q[i] >> (8 * occ[i])) & 0xFF) \
                        & MASK32
                    rng[i] = (rng[i] << 8) & MASK32
            hist[s] += 1
            out[j, i] = s
        f = f + inc * hist
        total += inc * act
    return out.reshape(-1)[:n].tobytes()


@pytest.mark.parametrize("k,inc,limit_log2,pivots,ahead", [
    (8, 24, 16, True, 2), (32, 255, 16, True, 1), (64, 255, 16, False, 0),
    (16, 24, 18, False, 0), (1, 24, 16, True, 2)])
def test_decode_model_reads_the_oracles_containers(k, inc, limit_log2, pivots,
                                                   ahead):
    """The model of kernel L decodes the oracle's CT-RC2 containers (two
    and three slots, each lane's words 0, 1 or 2 ahead, the pivot search
    and the 8-halving one) and agrees with the plain loop."""
    data = _zipf(k * 60 + 3, k + inc).tobytes()
    blob = tref.adaptive_encode(data, lanes=k, inc=inc, limit_log2=limit_log2)
    r = ByteReader(blob)
    n = r.u32()
    _, wide = tref._parse_lane_desc(r.u8())
    r.u8(), r.u8()
    words = layout.payload_words(r, k, wide, "cpu")
    stride = -(-n // k)
    lens = layout.lane_lengths_interleaved(n, k, stride, "cpu")
    got = model_decode(rc_common.i32_to_u32(words).numpy(),
                       lens.numpy(), n, inc, limit_log2, pivots, ahead)
    assert got == data
    plain = range_ops.decode_symbols_plain(words, lens, n, stride, None, inc,
                                           limit_log2)
    assert plain.numpy().tobytes() == data


def test_total_past_2_16_takes_a_third_event_row():
    """At lanes 1,024, inc 255, limit_log2 16 the plain J writes three
    event rows a step, some lane uses the third, and kernel B's plain
    version turns the grid into the oracle's payload."""
    data = corpus_file("grammar.lsp")
    k, n = 1024, len(data)
    stride = -(-n // k)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    lens = layout.lane_lengths_interleaved(n, k, stride, "cpu")
    ev = range_kernels.encode_events(layout.pad2d_interleaved(x, k, stride),
                                     lens, None, 255, 16)
    assert ev.shape == (3 * stride + 2, k)
    assert ev[2:3 * stride:3].any()
    rows, sizes = expand.materialize_rows(ev)
    want = tref.adaptive_encode(data, lanes=k, inc=255, limit_log2=16)
    assert layout.assemble(
        lambda wide: range_ops.adaptive_header(n, k, wide, 255, 16),
        rows.numpy(), sizes.numpy()) == want
