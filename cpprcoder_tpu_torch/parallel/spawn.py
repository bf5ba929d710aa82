"""Start a world of n ranks on this host and collect what each returns.

`run(n, fn, ...)` starts n processes with the `spawn` start method (CUDA
does not survive `fork`), joins them into a world through a FileStore in a
temporary directory (no network address: gloo's and NCCL's own sockets stay
on the loopback interface), calls fn(*args, **kwargs) in each, and returns
each rank's value, numpy arrays and other picklable objects, to the caller,
in rank order. fn must be a function of this package's modules: the
children import it, and nothing else of the caller.

A rank that raises ends the run: the others are stopped, and `run` raises
RuntimeError with that rank's traceback. So does a world that does not
finish within `timeout` seconds.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

# the modules a rank of the port must not load (the JAX package and JAX)
FOREIGN = ("jax", "jaxlib", "cpprcoder_tpu")


@dataclass
class RankResult:
    """What one rank gave back: fn's value, the foreign modules it had
    loaded when it ended (none, for the port), and the launches of the
    sharded paths' kernels inside its sharded calls (dryrun.SHARDED)."""
    value: object
    foreign: list
    launches: dict


def _rank(rank, world, store_path, backend, device, fn, args, kwargs, out):
    try:
        import torch.distributed as dist

        from cpprcoder_tpu_torch.parallel import dryrun, mesh

        mesh.init_world(rank, world, backend, device,
                        store=dist.FileStore(store_path, world))
        try:
            value = fn(*args, **kwargs)
        finally:
            dist.destroy_process_group()
        foreign = sorted(m for m in sys.modules
                         if m.split(".")[0] in FOREIGN)
        out.put((rank, True, RankResult(value, foreign,
                                        dict(dryrun.SHARDED))))
    except BaseException:   # the parent reports it and stops the world
        out.put((rank, False, traceback.format_exc()))
        raise


def run(n: int, fn, *args, backend: str | None = None,
        device: str | None = None, timeout: float = 900.0,
        **kwargs) -> list[RankResult]:
    """fn(*args, **kwargs) on each rank of a new world of n; -> each rank's
    RankResult, in rank order. backend and device as mesh.resolve takes
    them (checked here first, so that a world NCCL would refuse raises
    before any process starts)."""
    from cpprcoder_tpu_torch.parallel import mesh

    mesh.resolve(backend, device, n)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ct-world-")
    procs = [ctx.Process(target=_rank, args=(r, n, os.path.join(tmp, "store"),
                                             backend, device, fn, args,
                                             kwargs, out), daemon=True)
             for r in range(n)]
    results: list = [None] * n
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + timeout
        got = 0
        while got < n:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                # a rank that died without a word (a crash) ends the world
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and results[r] is None]
                if dead or time.monotonic() > end:
                    raise RuntimeError(
                        f"world of {n}: ranks {dead} ended with codes "
                        f"{[procs[r].exitcode for r in dead]} and no result"
                        if dead else f"world of {n}: no result within "
                        f"{timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{res}")
            results[rank] = res
            got += 1
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return results
