"""The port's own copies of the JAX package's numpy-only modules (config,
core/bytesutil, core/hashing, the numpy models, the oracles in reference/)
against their originals, and the rule that the port imports nothing of the JAX package:
no import statement names it, and running every codec leaves neither jax
nor any cpprcoder_tpu module in sys.modules."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import std_cases

from cpprcoder_tpu import config as jconfig
from cpprcoder_tpu.bench import harness as jharness
from cpprcoder_tpu.bench import ratio_sim as jratio_sim
from cpprcoder_tpu.bench import rcq_sim as jrcq_sim
from cpprcoder_tpu.bench import rcx_sim as jrcx_sim
from cpprcoder_tpu.bench import synth as jsynth
from cpprcoder_tpu.core import hashing as jhash
from cpprcoder_tpu.models import cxmodel as jcx
from cpprcoder_tpu.models import freq_header as jfh
from cpprcoder_tpu.models import huffman as jhuf
from cpprcoder_tpu.models import qmodel as jq
from cpprcoder_tpu.models import static_table as jst
from cpprcoder_tpu.reference import ans2_ref as jans2_ref
from cpprcoder_tpu.reference import ase_ref as jase_ref
from cpprcoder_tpu.reference import bwt_ref as jbwt_ref
from cpprcoder_tpu.reference import huffman_ref as jhuf_ref
from cpprcoder_tpu.reference import mtf_ref as jmtf_ref
from cpprcoder_tpu.reference import o1_ref as jo1_ref
from cpprcoder_tpu.reference import rans_ref as jrans_ref
from cpprcoder_tpu.reference import rc_ref as jrc_ref
from cpprcoder_tpu.reference import rcq_ref as jrcq_ref
from cpprcoder_tpu.reference import rcx_ref as jrcx_ref
from cpprcoder_tpu.reference import rle0_ref as jrle0_ref
from cpprcoder_tpu.reference import slz4_ref as jslz4_ref
from cpprcoder_tpu_torch import config as tconfig
from cpprcoder_tpu_torch.bench import harness as tharness
from cpprcoder_tpu_torch.bench import ratio_sim as tratio_sim
from cpprcoder_tpu_torch.bench import rcq_sim as trcq_sim
from cpprcoder_tpu_torch.bench import rcx_sim as trcx_sim
from cpprcoder_tpu_torch.bench import synth as tsynth
from cpprcoder_tpu_torch.core import hashing as thash
from cpprcoder_tpu_torch.models import cxmodel as tcx
from cpprcoder_tpu_torch.models import freq_header as tfh
from cpprcoder_tpu_torch.models import huffman as thuf
from cpprcoder_tpu_torch.models import qmodel as tq
from cpprcoder_tpu_torch.models import static_table as tst
from cpprcoder_tpu_torch.reference import ans2_ref as tans2_ref
from cpprcoder_tpu_torch.reference import ase_ref as tase_ref
from cpprcoder_tpu_torch.reference import bwt_ref as tbwt_ref
from cpprcoder_tpu_torch.reference import huffman_ref as thuf_ref
from cpprcoder_tpu_torch.reference import mtf_ref as tmtf_ref
from cpprcoder_tpu_torch.reference import o1_ref as to1_ref
from cpprcoder_tpu_torch.reference import rans_ref as trans_ref
from cpprcoder_tpu_torch.reference import rc_ref as trc_ref
from cpprcoder_tpu_torch.reference import rcq_ref as trcq_ref
from cpprcoder_tpu_torch.reference import rcx_ref as trcx_ref
from cpprcoder_tpu_torch.reference import rle0_ref as trle0_ref
from cpprcoder_tpu_torch.reference import slz4_ref as tslz4_ref

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cpprcoder_tpu_torch"

# (JAX package's oracle, the port's copy): encode, decode
ORACLES = {
    "rcx": ((jrcx_ref.rcx_encode, jrcx_ref.rcx_decode),
            (trcx_ref.rcx_encode, trcx_ref.rcx_decode)),
    "rcq": ((jrcq_ref.rcq_encode, jrcq_ref.rcq_decode),
            (trcq_ref.rcq_encode, trcq_ref.rcq_decode)),
    "rans": ((jrans_ref.rans_encode, jrans_ref.rans_decode),
             (trans_ref.rans_encode, trans_ref.rans_decode)),
    "huffman": ((jhuf_ref.huffman_encode, jhuf_ref.huffman_decode),
                (thuf_ref.huffman_encode, thuf_ref.huffman_decode)),
    "static_range": ((jrc_ref.static_encode, jrc_ref.static_decode),
                     (trc_ref.static_encode, trc_ref.static_decode)),
    "adaptive_range": ((jrc_ref.adaptive_encode, jrc_ref.adaptive_decode),
                       (trc_ref.adaptive_encode, trc_ref.adaptive_decode)),
    "blocksort": ((lambda d: jbwt_ref.bwt_encode(d, block_log2=9),
                   jbwt_ref.bwt_decode),
                  (lambda d: tbwt_ref.bwt_encode(d, block_log2=9),
                   tbwt_ref.bwt_decode)),
    "mtf": ((jmtf_ref.mtf_encode, jmtf_ref.mtf_decode),
            (tmtf_ref.mtf_encode, tmtf_ref.mtf_decode)),
    "mtf1": ((lambda d: jmtf_ref.mtf_encode(d, True), jmtf_ref.mtf_decode),
             (lambda d: tmtf_ref.mtf_encode(d, True), tmtf_ref.mtf_decode)),
    "rle0": ((jrle0_ref.rle0_encode, jrle0_ref.rle0_decode),
             (trle0_ref.rle0_encode, trle0_ref.rle0_decode)),
    "ase": ((jase_ref.ase_encode, jase_ref.ase_decode),
            (tase_ref.ase_encode, tase_ref.ase_decode)),
    "adaptive_o1": ((jo1_ref.o1_encode, jo1_ref.o1_decode),
                    (to1_ref.o1_encode, to1_ref.o1_decode)),
    "adaptive_rans": ((jans2_ref.ans2_encode, jans2_ref.ans2_decode),
                      (tans2_ref.ans2_encode, tans2_ref.ans2_decode)),
    # the v1 parse (the oracle's default) and the v2 parse, both seg_log2
    "slz4": ((lambda d: jslz4_ref.slz4_encode(d, seg_log2=9),
              jslz4_ref.slz4_decode),
             (lambda d: tslz4_ref.slz4_encode(d, seg_log2=9),
              tslz4_ref.slz4_decode)),
    "slz4_v2": ((lambda d: jslz4_ref.slz4_encode(d, parse="v2"),
                 jslz4_ref.slz4_decode),
                (lambda d: tslz4_ref.slz4_encode(d, parse="v2"),
                 tslz4_ref.slz4_decode)),
}


@pytest.mark.parametrize("codec", list(ORACLES))
def test_oracle_copies_write_the_same_bytes(codec):
    (jenc, jdec), (tenc, tdec) = ORACLES[codec]
    for data in std_cases():
        blob = tenc(data)
        assert blob == jenc(data)
        assert tdec(blob) == data == jdec(blob)


def test_constants_and_lane_policy():
    for name in ("RC_TOP", "MASK32", "ANS_PROB_BITS", "ANS_TOTAL", "ANS_LOW",
                 "HUF_MAX_BITS", "MAX_LANES_LOG2", "STATIC_TOTAL_BITS",
                 "STATIC_TOTAL", "ADAPTIVE_INC_DEFAULT",
                 "ADAPTIVE_LIMIT_LOG2_DEFAULT"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    for name in ("QBITS", "QTOTAL", "QRESERVE", "CLIMIT_LOG2", "INC_DEFAULT",
                 "MAX_K_TIMES_INC"):
        assert getattr(tq, name) == getattr(jq, name), name
    for name in ("WLOG_DEFAULT", "RESCALE_ROUNDS", "CBITS_SMALL", "CBITS_MID",
                 "CBITS_BIG", "N_SMALL", "N_MID"):
        assert getattr(tcx, name) == getattr(jcx, name), name
    rng = np.random.default_rng(21)
    sizes = np.concatenate([np.arange(0, 70), 2 ** np.arange(0, 27),
                            rng.integers(0, 1 << 26, 300)])
    for n in map(int, sizes):
        assert tconfig.pick_lanes(n) == jconfig.pick_lanes(n), n
        assert tq.rcq_params(n) == jq.rcq_params(n), n
        for mode in ("balanced", "ratio"):
            assert tcx.rcx_params(n, mode=mode) == jcx.rcx_params(n, mode=mode)
    for k in 2 ** np.arange(0, 17):
        for inc in (1, 24, 255):
            for limit_log2 in (8, 16, 20):
                assert (tconfig.adaptive_params_for(int(k), inc, limit_log2)
                        == jconfig.adaptive_params_for(int(k), inc, limit_log2))
    for lanes in (1, 8, 32, 256, 2048):
        for inc in (None, 1, 24):
            assert tq.rcq_params(5000, lanes, inc) == jq.rcq_params(5000, lanes, inc)
            for cbits in (None, 0, 8):
                assert (tcx.rcx_params(5000, lanes, inc, cbits)
                        == jcx.rcx_params(5000, lanes, inc, cbits))


def _histograms(seed, count=40):
    """Seeded 256-bin histograms: sparse, skewed, flat, one symbol, huge."""
    rng = np.random.default_rng(seed)
    out = [np.zeros(256, np.int64), np.eye(256, dtype=np.int64)[7] * 9999]
    for i in range(count):
        h = rng.integers(0, 10 ** rng.integers(1, 8), 256)
        h[rng.random(256) < rng.random()] = 0
        out.append(h)
        out.append((2.0 ** -np.minimum(np.arange(256) // (i % 16 + 1), 40)
                    * 1e9).astype(np.int64))
    return out


def test_slz4_constants_and_tables():
    """The oracle's constants, and its v2 match table and token lists, as
    the original's."""
    for name in ("MAX_DISTANCE", "MIN_MATCH", "END_LITERALS",
                 "LAST_MATCH_GUARD", "LCP_CAP", "D_UP", "D_DN", "W_EXACT",
                 "LADDER_LO"):
        assert getattr(tslz4_ref, name) == getattr(jslz4_ref, name), name
    for data in std_cases():
        seg = np.frombuffer(data, np.uint8)
        for t, j in zip(tslz4_ref.match_table_v2(seg),
                        jslz4_ref.match_table_v2(seg)):
            assert np.array_equal(t, j)
        for lazy in (True, False):
            assert (tslz4_ref.parse_segment_v2(seg, lazy)
                    == jslz4_ref.parse_segment_v2(seg, lazy))
            assert (tslz4_ref.parse_segment(seg, lazy)
                    == jslz4_ref.parse_segment(seg, lazy))


def test_xxh32_copies():
    """core/hashing: the scalar and numpy twins are the original's, and the
    torch twin (any device; the JAX package's jnp twin's place) equals
    them and the jnp twin."""
    import jax.numpy as jnp

    rng = np.random.default_rng(25)
    v = np.concatenate([np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                                 np.uint32),
                        rng.integers(0, 1 << 32, 4000, dtype=np.uint64)
                        .astype(np.uint32)])
    for name in ("P1", "P2", "P3", "P4", "P5", "M"):
        assert getattr(thash, name) == getattr(jhash, name), name
    for seed in (0, 1, 12345, 0x7FFF0000):
        want = jhash.xxh32_u32_np(v, seed)
        assert np.array_equal(thash.xxh32_u32_np(v, seed), want)
        assert np.array_equal(np.asarray(jhash.xxh32_u32_jnp(jnp.asarray(v),
                                                             seed)), want)
        got = thash.xxh32_u32_torch(torch.from_numpy(v.astype(np.int64)),
                                    seed)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want.astype(np.int64))
        for x in v[:50].tolist():
            assert thash.xxh32_u32(x, seed) == jhash.xxh32_u32(x, seed)


def test_transform_layouts():
    """CT-BWT1's block layout and CT-MTF1's block size, as in the
    originals."""
    assert tmtf_ref.MTF_BLOCK == jmtf_ref.MTF_BLOCK
    assert tbwt_ref.MIN_TAIL_LOG2 == jbwt_ref.MIN_TAIL_LOG2
    rng = np.random.default_rng(24)
    for n in map(int, np.concatenate([np.arange(0, 600, 7),
                                      rng.integers(0, 1 << 24, 50)])):
        for block_log2 in (8, 9, 15, 19):
            assert (tbwt_ref.block_layout(n, block_log2)
                    == jbwt_ref.block_layout(n, block_log2))


def test_freq_tables_and_headers():
    for h in _histograms(22):
        for bits in (14, 16):
            if h.sum() == 0:
                continue
            f = tst.normalize_freqs(h, bits)
            assert np.array_equal(f, jst.normalize_freqs(h, bits))
            assert np.array_equal(tst.exclusive_cumsum(f),
                                  jst.exclusive_cumsum(f))
            assert tfh.pack_freqs(f) == jfh.pack_freqs(f)


def test_huffman_tables():
    for h in _histograms(23):
        lengths = thuf.package_merge_lengths(h)
        assert np.array_equal(lengths, jhuf.package_merge_lengths(h))
        for t, j in zip(thuf.build_encoder_table(h),
                        jhuf.build_encoder_table(h)):
            assert np.array_equal(t, j)
        for t, j in zip(thuf.build_canonical_decode_tables(lengths),
                        jhuf.build_canonical_decode_tables(lengths)):
            assert np.array_equal(t, j)
        assert np.array_equal(thuf.build_decoder_lut(lengths),
                              jhuf.build_decoder_lut(lengths))


@pytest.mark.parametrize("n,seed", [(1, 3), (50_000, 0), (300_000, 7),
                                    (2_000_000, 11)])
def test_synth_stream_copy(n, seed):
    """bench/synth.py makes the large CT-SB input on machines without JAX:
    the same bytes as the original for every size and seed. (Both return
    fewer than n bytes where a run section's size is not a multiple of
    512: 1,999,608 of 2,000,000 at seed 11.)"""
    got = tsynth.synth_stream(n, seed)
    assert got.dtype == np.uint8 and 0 < len(got) <= n
    assert np.array_equal(got, jsynth.synth_stream(n, seed))


def test_sim_copies():
    """bench/{ratio,rcq,rcx}_sim.py: the same bits and ratios as the
    originals on seeded inputs (text-like, random, one byte) over lane
    counts, windows, increments, limits and context widths."""
    rng = np.random.default_rng(26)
    inputs = [rng.integers(0, 256, 1000, dtype=np.uint8),
              np.frombuffer(b"the quick brown fox jumps " * 30, np.uint8),
              np.zeros(500, np.uint8),
              rng.integers(97, 110, 777, dtype=np.uint8)]
    assert tratio_sim.PER_LANE_BYTES == jratio_sim.PER_LANE_BYTES
    assert tratio_sim.HEADER_BYTES == jratio_sim.HEADER_BYTES
    for x in inputs:
        for k, uf, inc, limit in ((1, 1, 24, 1 << 17), (8, 4, 32, 1 << 12),
                                  (64, 8, 16, 1 << 10)):
            assert tratio_sim.simulate_ratio(x, k, uf, inc, limit) == \
                jratio_sim.simulate_ratio(x, k, uf, inc, limit)
        for k, inc, cl in ((1, 24, 1 << 16), (8, 32, 1 << 13),
                           (64, 16, 1 << 15)):
            assert np.array_equal(
                trcq_sim.quantize_counts(np.bincount(x, minlength=256) + 1),
                jrcq_sim.quantize_counts(np.bincount(x, minlength=256) + 1))
            assert trcq_sim.simulate_ratio(x, k, inc, cl) == \
                jrcq_sim.simulate_ratio(x, k, inc, cl)
            for cbits in (0, 3, 8):
                assert trcx_sim.simulate_ratio_ctx(x, k, inc, cl, cbits) == \
                    jrcx_sim.simulate_ratio_ctx(x, k, inc, cl, cbits)


def test_harness_tables():
    """bench/harness.py's corpus and reference tables are the original's."""
    assert tharness.CANTERBURY == jharness.CANTERBURY
    assert tharness.REF_RATIOS == jharness.REF_RATIOS
    assert tharness.SILESIA == jharness.SILESIA
    assert Path(tharness.data_dir()).resolve() == \
        Path(jharness.data_dir()).resolve()
    assert tharness.load("xargs.1") == jharness.load("xargs.1")


IMPORTS_JAX_PACKAGE = re.compile(
    r"^\s*(import\s+cpprcoder_tpu\b(?!_)|from\s+cpprcoder_tpu(\.|\s+import\b))",
    re.M)


def test_no_source_imports_the_jax_package():
    assert IMPORTS_JAX_PACKAGE.search("from cpprcoder_tpu.config import X")
    assert IMPORTS_JAX_PACKAGE.search("  import cpprcoder_tpu as ct")
    assert IMPORTS_JAX_PACKAGE.search("from cpprcoder_tpu import compress")
    assert not IMPORTS_JAX_PACKAGE.search("import cpprcoder_tpu_torch as ctt")
    assert not IMPORTS_JAX_PACKAGE.search("from cpprcoder_tpu_torch.ops import x")
    paths = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(paths) > 20
    assert {PKG / "codecs" / "stream.py", PKG / "codecs" / "resume.py",
            PKG / "bench" / "synth.py", PKG / "codecs" / "slz4.py",
            PKG / "ops" / "lz_ops.py", PKG / "ops" / "lz_kernels.py",
            PKG / "native" / "ctrc.py", PKG / "core" / "hashing.py",
            PKG / "reference" / "slz4_ref.py", PKG / "ops" / "ans2_ops.py",
            PKG / "ops" / "ans2_kernels.py", PKG / "reference" / "ans2_ref.py",
            PKG / "codecs" / "adaptive_rans.py", PKG / "cli.py",
            PKG / "debug.py", PKG / "utils" / "profiling.py",
            PKG / "bench" / "harness.py", PKG / "bench" / "compare.py",
            PKG / "bench" / "ratio_sim.py", PKG / "bench" / "rcq_sim.py",
            PKG / "bench" / "rcx_sim.py", PKG / "parallel" / "mesh.py",
            PKG / "parallel" / "spawn.py", PKG / "parallel" / "sharded.py",
            PKG / "parallel" / "sharded_rcq.py",
            PKG / "parallel" / "sharded_rcx.py",
            PKG / "parallel" / "launch.py",
            PKG / "parallel" / "dryrun.py"} <= set(paths)
    for path in paths:
        assert not IMPORTS_JAX_PACKAGE.search(path.read_text()), path


def test_running_every_codec_loads_nothing_of_jax():
    code = """
import sys
import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu_torch import cli, debug
from cpprcoder_tpu_torch.bench import compare, harness, ratio_sim, rcq_sim, rcx_sim
from cpprcoder_tpu_torch.bench.synth import synth_stream
from cpprcoder_tpu_torch.codecs import resume, stream
from cpprcoder_tpu_torch.codecs.pipeline import make_pipeline
from cpprcoder_tpu_torch.native import ctrc
from cpprcoder_tpu_torch.parallel import dryrun, launch, mesh, spawn
from cpprcoder_tpu_torch.parallel import sharded, sharded_rcq, sharded_rcx
from cpprcoder_tpu_torch.utils import profiling
data = bytes(range(256)) * 3 + b"no jax here " * 50
m = mesh.make_mesh(device="cpu")
x = __import__("numpy").frombuffer(data, "uint8")
shard, _ = sharded_rcx.sharded_rcx_encode(x, m, k_global=16)
assert shard.total == int(shard.totals.sum()) and shard.offset == 0
assert sharded.sharded_histogram(x, m).sum() == len(data)
for codec in ctt.list_codecs():
    for opts in ({"device": "cpu"}, {"backend": "ref"}):
        blob = ctt.compress(data, codec=codec, **opts)
        assert ctt.decompress(blob, codec=codec, **opts) == data, codec
enc = stream.SuperblockEncoder("rcq", sb_log2=9, device="cpu")
enc.feed(data)
blob = enc.finish()
assert stream.stream_decode_range(blob, 500, 900, device="cpu") == data[500:900]
enc = resume.RCQResumableEncoder(len(data), lanes=8, chunk_steps=8,
                                 device="cpu")
enc.feed(data[:700])
enc = resume.RCQResumableEncoder.resume(enc.checkpoint(), device="cpu")
enc.feed(data[700:])
assert enc.finish() == ctt.compress(data, codec="rcq", lanes=8, backend="ref")
assert 0 < len(synth_stream(5000, 1)) <= 5000
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "cpprcoder_tpu"
             or m.startswith("cpprcoder_tpu."))
print(len(ctt.list_codecs()), bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(None, 1) == ["16", "[]\n"]


def test_launch_help_loads_nothing_of_jax():
    """python -m cpprcoder_tpu_torch.parallel.launch --help prints its
    usage and loads neither jax nor the JAX package."""
    out = subprocess.run(
        [sys.executable, "-m", "cpprcoder_tpu_torch.parallel.launch",
         "--help"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--blocks-per-shard" in out.stdout and "--backend" in out.stdout
    code = """
import runpy, sys
sys.argv = ["launch", "--help"]
try:
    runpy.run_module("cpprcoder_tpu_torch.parallel.launch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0
import cpprcoder_tpu_torch.parallel.launch
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "cpprcoder_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
