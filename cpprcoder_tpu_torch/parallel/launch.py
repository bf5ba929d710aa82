"""One-command distributed CT-RCX round trip (counterpart of
cpprcoder_tpu/parallel/launch.py):

    torchrun --standalone --nproc-per-node N \\
        -m cpprcoder_tpu_torch.parallel.launch [total_bytes] [--hosts N]
        [--lanes 64] [--blocks-per-shard 2] [--backend nccl|gloo]
        [--device cuda|cpu]

Each process started by torchrun joins the world that torchrun describes
(mesh.multihost_init); run without torchrun, it is a world of one. The mesh
is data x lane over the world (lane = 2 where the world is even), the
input the port's bench/synth.synth_stream(total_bytes, seed=0), split into
blocks-per-shard superblocks a data shard. Every rank encodes its shard
(sharded_rcx_encode), the shards' payloads are gathered into every
block's word rows, and the mesh decodes them (sharded_rcx_decode); rank 0
prints one JSON line: devices (the world), hosts, mesh, bytes, blocks,
lanes, compressed, enc_wall_s, dec_wall_s, roundtrip_ok, and backend,
device, the decode's steps and exchanges and the kernels' launches in the
sharded calls, summed over the ranks.
`--hosts N` declares the node count the launcher was asked for (world
size over the local world size) and is checked, not acted on: starting
the processes is the launcher's job. The exit code is 0 where every rank
round-trips.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="distributed CT-RCX round trip")
    p.add_argument("total_bytes", nargs="?", type=int, default=1 << 24)
    p.add_argument("--hosts", type=int, default=None,
                   help="expected node count (checked only)")
    p.add_argument("--lanes", type=int, default=64,
                   help="global lane count (split over the 'lane' axis)")
    p.add_argument("--blocks-per-shard", type=int, default=2)
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from cpprcoder_tpu_torch.bench.synth import synth_stream
    from cpprcoder_tpu_torch.parallel import dryrun, sharded
    from cpprcoder_tpu_torch.parallel.mesh import (
        init_world,
        make_mesh,
        multihost_init,
        resolve,
        world_objects,
    )
    from cpprcoder_tpu_torch.parallel.sharded_rcx import (
        sharded_rcx_decode,
        sharded_rcx_encode,
    )

    if not multihost_init(args.backend, args.device):
        # not started by a launcher: a world of one, on the asked backend
        from torch.distributed import HashStore

        resolve(args.backend, args.device, 1)
        init_world(0, 1, args.backend, args.device, store=HashStore())
    world = dist.get_world_size()
    hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if args.hosts is not None and hosts != args.hosts:
        if dist.get_rank() == 0:
            print(json.dumps({"error": f"--hosts {args.hosts} but the "
                              f"world has {hosts} node(s) (launcher "
                              f"mismatch)"}))
        dist.destroy_process_group()
        return 1
    try:
        mesh = make_mesh()
        blocks = mesh.data * args.blocks_per_shard
        x = synth_stream(args.total_bytes, seed=0)

        t0 = time.perf_counter()
        shard, (blocks, n_vec, stride_vec, steps) = dryrun.counted(
            sharded_rcx_encode, x, mesh, blocks=blocks, k_global=args.lanes)
        t_enc = time.perf_counter() - t0
        rows3d = sharded.word_rows3d(sharded.gather_blocks(shard, mesh,
                                                           args.lanes))
        dist.barrier()
        t0 = time.perf_counter()
        out = dryrun.counted(sharded_rcx_decode, rows3d, n_vec, stride_vec,
                             mesh, steps, k_global=args.lanes)
        t_dec = time.perf_counter() - t0

        per_block = -(-len(x) // blocks)
        l0, ko = mesh.lanes(args.lanes)
        ok = True
        for i, b in enumerate(mesh.blocks(blocks)):
            st, nb = int(stride_vec[b]), int(n_vec[b])
            xb = np.zeros(args.lanes * st, np.uint8)
            xb[:nb] = x[b * per_block: b * per_block + nb]
            want = xb.reshape(args.lanes, st)[l0:l0 + ko]
            ok &= bool((out[i, :st].T == want).all())
        got = world_objects((ok, dict(dryrun.SHARDED)), mesh)
        oks = [o for o, _ in got]
        launches = {nm: sum(c[nm] for _, c in got) for nm in got[0][1]}
        if mesh.rank == 0:
            print(json.dumps({
                "devices": world, "hosts": hosts, "mesh": mesh.shape,
                "bytes": len(x), "blocks": blocks, "lanes": args.lanes,
                "compressed": int(shard.totals.sum()),
                "enc_wall_s": round(t_enc, 3), "dec_wall_s": round(t_dec, 3),
                "roundtrip_ok": all(oks), "backend": mesh.backend,
                "device": str(mesh.device),
                "steps": steps, "exchanges": mesh.stats["exchanges"],
                "launches": launches}), flush=True)
        return 0 if all(oks) else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
