"""Per-phase profiling counters and device traces of the port (counterpart
of cpprcoder_tpu/utils/profiling.py, with the same surface).

Named phase counters accumulate host wall-clock time (and a byte count) at
the dispatch sites, under the JAX package's names: `enc.scan`,
`enc.materialize` and `enc.assemble` where a lane-payload container is
encoded (ops/range_ops.encode_container: CT-RC1, CT-RC2, CT-RCQ and
CT-RCX), `dec.rows`, `dec.scan` and `dec.fetch` where CT-RCQ and CT-RCX are
decoded (ops/rcq_ops.rcq_decode, ops/rcx_ops.rcx_decode).

A kernel launch returns before the card has run it, so a host clock around
it would measure the enqueue alone: where a phase is given a CUDA device,
that device is synchronized when the phase starts and again before its
clock stops, so a phase counts its own device work and nothing queued
before it. Enable with CT_PROFILE=1 (env) or `enable()`; when disabled a
phase costs one falsy check and no synchronize.

Usage:
    from cpprcoder_tpu_torch.utils import profiling
    profiling.enable()
    ... compress / decompress ...
    print(profiling.format_report())

Device timeline (a torch.profiler trace, viewable in Perfetto or
TensorBoard):
    with profiling.device_trace("trace-dir"):
        ... work on the card ...
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_ENABLED = os.environ.get("CT_PROFILE", "") not in ("", "0")
# name -> [calls, wall_seconds, bytes]
_COUNTERS: dict[str, list] = {}


class Record:
    """What a phase yields: its byte count, which the block may set once it
    knows it (a payload's size after it is materialized)."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int = 0):
        self.nbytes = nbytes


_OFF = Record()   # yielded by a disabled phase; nothing reads it


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    _COUNTERS.clear()


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase(name: str, nbytes: int = 0, device=None):
    """Accumulate wall time (and a byte count) under `name`; where `device`
    is a CUDA device, it is synchronized at the phase's start and end.
    Yields a Record whose nbytes the block may set."""
    if not _ENABLED:
        yield _OFF
        return
    _sync(device)
    rec = Record(nbytes)
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        _sync(device)
        dt = time.perf_counter() - t0
        row = _COUNTERS.setdefault(name, [0, 0.0, 0])
        row[0] += 1
        row[1] += dt
        row[2] += rec.nbytes


def add(name: str, seconds: float, nbytes: int = 0) -> None:
    """Record a duration measured elsewhere (for example a kernel's time
    from CUDA events)."""
    if not _ENABLED:
        return
    row = _COUNTERS.setdefault(name, [0, 0.0, 0])
    row[0] += 1
    row[1] += seconds
    row[2] += nbytes


def report() -> dict[str, dict]:
    """{phase: {calls, wall_s, bytes, MBps}}; MBps only where bytes > 0."""
    out = {}
    for name, (calls, wall, nbytes) in sorted(_COUNTERS.items()):
        row = {"calls": calls, "wall_s": wall, "bytes": nbytes}
        if nbytes and wall > 0:
            row["MBps"] = nbytes / wall / 1e6
        out[name] = row
    return out


def format_report() -> str:
    """The report as a Markdown table."""
    lines = ["| phase | calls | wall s | bytes | MB/s |",
             "|---|---|---|---|---|"]
    for name, row in report().items():
        mbps = f"{row['MBps']:.1f}" if "MBps" in row else "-"
        lines.append(f"| {name} | {row['calls']} | {row['wall_s']:.4f} "
                     f"| {row['bytes']} | {mbps} |")
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler trace of the CPU and, where CUDA is available, the
    card around a block, written to `log_dir` as a Chrome trace
    (trace.json)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
