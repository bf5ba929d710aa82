"""The rescale threshold climit = 1 << climit_log2 (header byte 6 of CT-RCX
and CT-RCQ, any u8 value) on the CPU path, held against the numpy oracle
(not against the JAX package: its CT-RCX encoders ignore climit_log2, and
from 32 on its uint32 counts refuse the threshold).

The port carries climit as a Python int down to `rc_common.climit_u32`,
which clamps a threshold past 2^32 - 1 to 2^32 - 1 (no row's total reaches
either while 256 + n*inc < 2^32 - 1) and raises past that bound; the
kernels take the u32 (tests/test_torch_gpu.py holds them on the card)."""

from pathlib import Path

import pytest
import torch

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu_torch.config import MASK32
from cpprcoder_tpu_torch.ops import rc_common, rcx_kernels
from cpprcoder_tpu_torch.reference import rcq_ref, rcx_ref

DATA = (Path(__file__).resolve().parent.parent / "data"
        / "grammar.lsp").read_bytes()[:1500]
ORACLE = {"rcx": (rcx_ref.rcx_encode, rcx_ref.rcx_decode),
          "rcq": (rcq_ref.rcq_encode, rcq_ref.rcq_decode)}


@pytest.mark.parametrize("climit_log2", [31, 32, 40, 64, 255])
@pytest.mark.parametrize("codec", ["rcx", "rcq"])
def test_large_climit_matches_the_oracle(codec, climit_log2):
    encode, decode = ORACLE[codec]
    want = encode(DATA, climit_log2=climit_log2)
    assert want[6] == climit_log2 and decode(want) == DATA
    blob = ctt.compress(DATA, codec=codec, device="cpu",
                        climit_log2=climit_log2)
    assert blob == want
    assert ctt.decompress(want, codec=codec, device="cpu") == DATA


def test_climit_u32_clamps_exactly_and_raises_past_the_bound():
    assert rc_common.climit_u32(16, 10 ** 6, 24) == 1 << 16
    assert rc_common.climit_u32(31, 10 ** 9, 1) == 1 << 31
    for log2 in (32, 40, 64, 255):
        assert rc_common.climit_u32(log2, 10 ** 6, 255) == MASK32
    # 256 + n*inc just below 2^32 - 1 is exact; from 2^32 - 1 on it raises
    n = (MASK32 - 256) // 2
    assert rc_common.climit_u32(32, n - 1, 2) == MASK32
    with pytest.raises(ValueError, match="u32 counts"):
        rc_common.climit_u32(32, n + 1, 2)
    with pytest.raises(ValueError, match="u32 counts"):
        rc_common.climit_u32(64, 1 << 32, 1)


def test_kernel_wrappers_take_a_u32_climit():
    """The coder wrappers take climit in [1, 2^32 - 1] (the kernels compare
    in u32; 2^31 and above used to be refused on the card) and refuse
    anything outside it."""
    k, stride = 8, 5
    x2d = torch.zeros((stride, k), dtype=torch.uint8)
    lens = torch.full((k,), stride, dtype=torch.int32)
    for climit in (1 << 31, MASK32):
        rcx_kernels.check_args("x2d", x2d, torch.uint8, lens, 6, 2, climit, 16)
    for climit in (0, 1 << 32):
        with pytest.raises(ValueError, match="climit"):
            rcx_kernels.check_args("x2d", x2d, torch.uint8, lens, 6, 2,
                                   climit, 16)
    ev = rcx_kernels.encode_events(x2d, lens, 16, MASK32, 6, 2)
    assert ev.shape == (2 * stride + 2, k)
