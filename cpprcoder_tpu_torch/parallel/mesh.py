"""The ('data', 'lane') mesh over a torch.distributed world (counterpart of
cpprcoder_tpu/parallel/mesh.py).

Rank r of a world of data * lane ranks sits at data index r // lane and
lane index r % lane, as the JAX package's mesh lays its devices out
(np.reshape(devices, (data, lane))). The 'data' axis carries independent
superblocks, one model each; the 'lane' axis splits the K lanes of a
superblock into `lane` ranges of K / lane lanes, whose ranks form a lane
group (one process group each); the ranks of one lane index across the
data axis form a data group.

The backend is explicit. "nccl" is the default on the card and takes one
card a rank: NCCL refuses two ranks of one communicator on one card (it
reports a duplicate GPU), so a world with more ranks on a host than the
host has cards raises here, and nothing switches to gloo on its own.
"gloo" is the backend where asked and on the CPU; with it, the ranks of a
world larger than the card count share cuda:0 (the kernels still run on the
card; the collectives go through the host). Each rank's device is
explicit: cuda:local_rank under NCCL, cuda:0 or cuda:local_rank under gloo,
or the CPU where asked.

The collectives the sharded coders need are here: `lane_gather` (a
rank's lanes to the lane group's), `group_sum` and `world_gather` (one
number a rank). Under gloo a gather is an all_reduce of a zeroed buffer in
which each rank fills its own slot, and a CUDA tensor goes through the
host (gloo documents all_reduce and broadcast for CUDA tensors, not the
gathers); NCCL gathers on the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

# the device init_world chose for this process (make_mesh's default)
_device: torch.device | None = None


def resolve(backend: str | None, device: str | None, world: int,
            local_rank: int = 0, local_world: int | None = None):
    """-> (backend, device) of a rank: device "cuda" (the default) or
    "cpu"; backend "nccl" (the default on the card) or "gloo". Raises
    ValueError where NCCL would be asked to put two ranks on one card, and
    RuntimeError where the card is asked for and there is none."""
    local_world = world if local_world is None else local_world
    device = device or "cuda"
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("backend 'nccl' runs on the card; pass "
                             "backend='gloo' for device='cpu'")
        if local_world > cards:
            raise ValueError(
                f"backend 'nccl' takes one card a rank: {local_world} ranks "
                f"on this host, {cards} card(s). NCCL refuses two ranks of "
                f"one communicator on one card (duplicate GPU); pass "
                f"backend='gloo' to share a card")
    if device == "cpu":
        return backend, torch.device("cpu")
    if cards == 0:
        raise RuntimeError("CUDA is not available; pass device='cpu' (and "
                           "backend='gloo') for the plain PyTorch path")
    return backend, torch.device(
        "cuda", local_rank if local_world <= cards else 0)


def _loopback():
    """Keep gloo's and NCCL's sockets on the loopback interface where the
    host has one: every rank of a world started here is on this host."""
    if os.path.exists("/sys/class/net/lo"):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")


def init_world(rank: int, world: int, backend: str | None = None,
               device: str | None = None, store=None, local_rank=None,
               local_world=None) -> torch.device:
    """Join a world (torch.distributed.init_process_group with this
    rank, world size and store, or torchrun's env:// where store is None)
    on the backend and device that `resolve` picks; -> this rank's
    device."""
    global _device
    local_rank = rank if local_rank is None else local_rank
    backend, dev = resolve(backend, device, world, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _loopback()
    kw = {"store": store} if store is not None else {"init_method": "env://"}
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    _device = dev
    return dev


def multihost_init(backend: str | None = None,
                   device: str | None = None) -> bool:
    """Join the world that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) when this
    process was started by it and has not joined yet; a no-op otherwise
    (a single process that was not launched). -> whether it joined."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ \
            or dist.is_initialized():
        return False
    world = int(os.environ["WORLD_SIZE"])
    init_world(int(os.environ["RANK"]), world, backend, device,
               local_rank=int(os.environ.get("LOCAL_RANK", 0)),
               local_world=int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    return True


@dataclass
class Mesh:
    """This rank's place in a data x lane mesh and the groups of its axes
    (None where an axis has one rank)."""
    data: int
    lane: int
    rank: int
    device: torch.device
    backend: str | None
    lane_group: object = None
    data_group: object = None
    # the last sharded call's seconds and exchanges (encode_s, decode_s,
    # exchanges), which the tools that run it report, and the lane group's
    # collectives so far (lane_gathers)
    stats: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "lane": self.lane}

    @property
    def world(self) -> int:
        return self.data * self.lane

    @property
    def data_index(self) -> int:
        return self.rank // self.lane

    @property
    def lane_index(self) -> int:
        return self.rank % self.lane

    def lanes(self, k_global: int) -> tuple[int, int]:
        """-> (l0, ko): this rank's lanes l0 .. l0 + ko - 1 of k_global."""
        ko = k_global // self.lane
        if ko * self.lane != k_global:
            raise ValueError(f"{k_global} lanes do not split over "
                             f"{self.lane} lane ranks")
        return self.lane_index * ko, ko

    def blocks(self, blocks: int) -> range:
        """This rank's blocks of `blocks` (its data shard's)."""
        if blocks % self.data:
            raise ValueError(f"{blocks} blocks do not split over "
                             f"{self.data} data shards")
        per = blocks // self.data
        return range(self.data_index * per, (self.data_index + 1) * per)


def make_mesh(data: int | None = None, lane: int | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh over the world this process joined (a world of one if it
    joined none), with the JAX package's defaults: lane = 2 where the world
    is even and larger than 1. Every rank of the world must call it, in the
    same order as its other groups (it makes the axes' groups)."""
    joined = dist.is_initialized()
    n = dist.get_world_size() if joined else 1
    if data is None and lane is None:
        lane = 2 if n % 2 == 0 and n > 1 else 1
        data = n // lane
    elif data is None:
        data = n // lane
    elif lane is None:
        lane = n // data
    if data * lane != n:
        raise ValueError(f"mesh {data}x{lane} != {n} ranks")
    rank = dist.get_rank() if joined else 0
    dev = torch.device(device) if device is not None else (
        _device or torch.device("cuda" if torch.cuda.is_available()
                                else "cpu"))
    mesh = Mesh(data, lane, rank, dev,
                dist.get_backend() if joined else None)
    if n > 1:
        # every rank makes every group, in one order
        for d in range(data):
            g = dist.new_group([d * lane + i for i in range(lane)])
            if d == mesh.data_index:
                mesh.lane_group = g
        for i in range(lane):
            g = dist.new_group([d * lane + i for d in range(data)])
            if i == mesh.lane_index:
                mesh.data_group = g
        if lane == 1:
            mesh.lane_group = None
        if data == 1:
            mesh.data_group = None
    return mesh


def _sum(t: torch.Tensor, group, backend) -> torch.Tensor:
    """all_reduce (sum) of t over group; gloo's of a CUDA tensor staged
    through the host here, so that no gloo CUDA path is relied on."""
    if backend == "gloo" and t.device.type == "cuda":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def _gather(t: torch.Tensor, ranks: int, slot: int, group, backend):
    """[ranks, *t.shape]: every rank's t in its slot."""
    if backend == "nccl":
        buf = torch.empty((ranks, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(buf, t.contiguous(), group=group)
        return buf
    buf = torch.zeros((ranks, *t.shape), dtype=t.dtype, device=t.device)
    buf[slot] = t
    return _sum(buf, group, backend)


def lane_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """t [..., ko], this rank's lanes -> [..., K], the lane group's lanes
    in order: one collective on the lane group (none where it has one
    rank)."""
    if mesh.lane == 1:
        return t
    buf = _gather(t, mesh.lane, mesh.lane_index, mesh.lane_group,
                  mesh.backend)
    mesh.stats["lane_gathers"] = mesh.stats.get("lane_gathers", 0) + 1
    return buf.movedim(0, -2).reshape(*t.shape[:-1], -1)


def group_sum(t: torch.Tensor, group, mesh: Mesh) -> torch.Tensor:
    """t summed over a group of the mesh, in place (nothing where the
    group is None)."""
    return t if group is None else _sum(t, group, mesh.backend)


def world_gather(value: int, mesh: Mesh) -> np.ndarray:
    """One int64 a rank -> every rank's, in rank order (data-major, as the
    JAX package's P(('data', 'lane')) lays out one value a shard)."""
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    if mesh.world == 1:
        return t.cpu().numpy()
    return _gather(t, mesh.world, mesh.rank, None,
                   mesh.backend)[:, 0].cpu().numpy()


def world_objects(obj, mesh: Mesh) -> list:
    """Every rank's picklable obj, in rank order (the host's copy)."""
    if mesh.world == 1:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj)
    return out
