"""The device mesh: node shards on the gp axis, data-parallel replicas on the
dp axis, and the collectives between them.

The counterpart of the JAX package's parallel/mesh.py.  Nodes, and with
them the band blocks of a DenseBandGraph, are split into gp contiguous
shards.  The gp axis may span OS processes (init_distributed): the shards
are then split evenly over the processes of a gp group, in order, and a
process holds only its own shards' tensors.  Everywhere in the port a
sharded node tensor is the list of the pieces this process holds, in shard
order (all gp of them in a one-process run); `mesh.local` names their
shard indices and only the helpers below know the layout.  The dp axis
(DQNAgent(mesh=...)) is one process a replica.  A world of dp × procs
processes is laid out dp-major: process r is replica r // procs and holds
gp shards' block r % procs.

Within a process a device may repeat: on one card every shard sits on it,
and the sharded engine (parallel/band_partition.py) runs the same kernels
and collectives as on a host with one card a shard, with no copy between
neighbours.  The collectives are what the JAX package's engine does with
ppermute, all_gather and psum:

  * `ring_halos` hands each shard its left neighbour's tail and its right
    neighbour's head (wrapping around, as the ppermute ring does): a view
    of the neighbour's rows where it is held here, else a
    `batch_isend_irecv` between neighbouring processes;
  * `all_gather` gives each device the shards' pieces joined in shard order
    (`dist.all_gather`, `all_gather_into_tensor` on NCCL);
  * `all_reduce` is a differentiable sum over an axis's processes: its
    backward all-reduces the gradient.  So a run that spans processes
    computes its loss as a sum of the processes' parts, each process
    differentiating its own part, and sums the parameter gradients
    afterwards (`reduce_grads`); `gather_parts` builds on it the graph-wide
    sums that every process needs with the same bits, adding the shards'
    partials in shard order as a one-process run does.

Under gloo, CUDA tensors go through the host inside these helpers.  NCCL
(`backend="nccl"`) needs one card a process.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from mdcommunity_tpu_torch.utils.device import resolve_device

Device = Union[str, torch.device]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> int:
    """Bring up the process group once a process, before building meshes;
    returns this process's index (the JAX package's init_distributed).

    With a coordinator address ("host:port") or num_processes > 1 the group
    is created from the arguments.  With none, torchrun's MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK are read where they are set; where they
    are not, the run is one process: 0 is returned and no group is created.
    A second call returns the rank and does nothing else.  backend: "nccl"
    where every process of the host has a card of its own, else "gloo" (by
    default chosen so from the card count and the processes a host,
    LOCAL_WORLD_SIZE or num_processes).  Where CUDA is available the
    process's card becomes cuda:{LOCAL_RANK % device_count} (LOCAL_RANK
    defaults to the process index): processes that outnumber the cards
    share them."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if coordinator_address is None and num_processes in (None, 1):
        if "MASTER_ADDR" not in env or "WORLD_SIZE" not in env:
            return 0
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    local_rank = int(env.get("LOCAL_RANK", process_id))
    per_host = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = "nccl" if cards >= per_host else "gloo"
    if cards:
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return process_id


@dataclasses.dataclass(frozen=True)
class GpMesh:
    """gp node shards and dp replicas.

    devices : the device of each shard this process holds (len(local)
              entries; they may repeat)
    procs   : the processes the gp axis spans; this process is the
              rank-th of them and holds shards local = [rank·gp/procs,
              (rank+1)·gp/procs)
    dp      : data-parallel replicas (one process each); this process is
              replica dp_rank
    backend : the process group's backend (None in a one-process run);
    gp_group, dp_group : the axes' process groups (None: the world's)"""

    gp: int
    devices: Tuple[torch.device, ...]
    procs: int = 1
    rank: int = 0
    dp: int = 1
    dp_rank: int = 0
    backend: Optional[str] = None
    gp_group: object = None
    dp_group: object = None

    def __post_init__(self):
        if self.gp < 1 or self.procs < 1 or self.gp % self.procs:
            raise ValueError(f"gp={self.gp} shards do not split over {self.procs} processes")
        if len(self.devices) != self.gp // self.procs:
            raise ValueError(f"a process of a gp={self.gp} mesh over {self.procs} processes "
                             f"holds {self.gp // self.procs} shards, got "
                             f"{len(self.devices)} devices")

    @property
    def local(self) -> range:
        """The shard indices this process holds, in order."""
        n = self.gp // self.procs
        return range(self.rank * n, (self.rank + 1) * n)

    @property
    def home(self) -> torch.device:
        """The first held shard's device: where gathers land (Q, the loss)."""
        return self.devices[0]

    @property
    def spans(self) -> bool:
        """True when the gp axis spans processes."""
        return self.procs > 1


def make_mesh(gp: int = 1, devices: Optional[Union[Device, Sequence[Device]]] = None,
              dp: int = 1, processes: Optional[int] = None) -> GpMesh:
    """A mesh of dp replicas of gp shards.  `devices` is a list of this
    process's shards' devices, or one device for all of them; by default
    this process's card (utils/device.resolve_device; init_distributed set
    it), so the shards run on CUDA unless the caller passes "cpu".

    processes: the processes the mesh spans, dp × procs (by default all of
    the process group's, 1 without a group); processes=1 builds a mesh of
    this process alone inside a multi-process run.  Every process of the
    mesh calls make_mesh with the same arguments (a dp × gp mesh over
    several processes each way creates its axes' groups)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    processes = world if processes is None else processes
    if processes == 1:
        procs, rank, dp_rank, backend = 1, 0, 0, None
        if dp != 1:
            raise ValueError(f"a dp={dp} mesh needs {dp} processes (init_distributed)")
    else:
        if processes != world or world % dp:
            raise ValueError(f"a mesh over {processes} processes with dp={dp}: the process "
                             f"group has {world}")
        procs = world // dp
        dp_rank, rank = divmod(dist.get_rank(), procs)
        backend = dist.get_backend()
    gp_group = dp_group = None
    if procs > 1 and dp > 1:
        for d in range(dp):
            g = dist.new_group([d * procs + j for j in range(procs)])
            gp_group = g if d == dp_rank else gp_group
        for j in range(procs):
            g = dist.new_group([d * procs + j for d in range(dp)])
            dp_group = g if j == rank else dp_group
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [resolve_device(devices)] * (gp // procs)
    return GpMesh(gp, tuple(_indexed(torch.device(d)) for d in devices), procs, rank, dp,
                  dp_rank, backend, gp_group, dp_group)


def _indexed(d: torch.device) -> torch.device:
    """"cuda" as the card it means ("cuda:<current>"), as tensors report it."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """x on `device`: x itself (or the view it is) where it is there already."""
    return x.to(device, non_blocking=True)


# ------------------------------------------------------- the axes' transport


def _axis(mesh: GpMesh, axis: str):
    """(processes, this process's index, group, global rank of index j)."""
    if axis == "gp":
        return (mesh.procs, mesh.rank, mesh.gp_group,
                lambda j: mesh.dp_rank * mesh.procs + j)
    if axis == "dp":
        return mesh.dp, mesh.dp_rank, mesh.dp_group, lambda d: d * mesh.procs + mesh.rank
    raise ValueError(f"unknown mesh axis {axis!r}")


def _wire(mesh: GpMesh, x: torch.Tensor) -> torch.Tensor:
    """x as the backend takes it: a contiguous copy of its own, on the host
    under gloo."""
    if mesh.backend == "gloo":
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone(memory_format=torch.contiguous_format)


def _all_reduce(mesh: GpMesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    n, _, group, _ = _axis(mesh, axis)
    if n == 1:
        return x
    w = _wire(mesh, x)
    dist.all_reduce(w, group=group)
    return w.to(x.device)


def _all_gather(mesh: GpMesh, x: torch.Tensor, axis: str = "gp") -> List[torch.Tensor]:
    """Every process's x (equal shapes) in process order, on x's device."""
    n, _, group, _ = _axis(mesh, axis)
    if n == 1:
        return [x]
    w = _wire(mesh, x)
    if mesh.backend == "nccl":
        out = torch.empty((n,) + w.shape, dtype=w.dtype, device=w.device)
        dist.all_gather_into_tensor(out, w, group=group)
        return list(out.to(x.device).unbind(0))
    out = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(out, w, group=group)
    return [o.to(x.device) for o in out]


class _AllReduce(torch.autograd.Function):
    """The sum over an axis's processes; the backward sums the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, g, ctx.axis), None, None


def all_reduce(mesh: GpMesh, x: torch.Tensor, axis: str = "gp") -> torch.Tensor:
    """x summed over the processes of the mesh's `axis` ("gp" or "dp"), on
    every one of them; differentiable, the backward all-reducing the
    gradient (so each process's loss is its part of the sum).  x itself
    where the axis is one process."""
    if _axis(mesh, axis)[0] == 1:
        return x
    return _AllReduce.apply(x, mesh, axis)


def gather_parts(mesh: GpMesh, parts: Sequence[torch.Tensor], axis: str = "gp"
                 ) -> List[torch.Tensor]:
    """Every slot's part on the first held shard's device, on every
    process: on the gp axis `parts` are this process's shards' (a slot a
    shard), on the dp axis one tensor (a slot a replica).  Exact copies
    (an all-reduce of the parts beside zeros) and differentiable, so a sum
    of them in slot order has the same bits on every process, and the bits
    that a one-process run adds."""
    n, idx, _, _ = _axis(mesh, axis)
    if n == 1:
        return [_to(p, mesh.home) for p in parts]
    mine = list(mesh.local) if axis == "gp" else [idx]
    if len(parts) != len(mine):
        raise ValueError(f"expected {len(mine)} parts, got {len(parts)}")
    zero = torch.zeros_like(_to(parts[0], mesh.home))
    held = dict(zip(mine, parts))
    n_slots = mesh.gp if axis == "gp" else mesh.dp
    slots = torch.stack([_to(held[i], mesh.home) if i in held else zero
                         for i in range(n_slots)])
    return list(all_reduce(mesh, slots, axis).unbind(0))


def reduce_grads(mesh: GpMesh, params, axis: str = "gp") -> None:
    """Sum the parameters' .grad over the axis's processes, in place, in one
    all-reduce (a parameter without one gets zeros first)."""
    if _axis(mesh, axis)[0] == 1:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = _all_reduce(mesh, torch.cat([p.grad.reshape(-1) for p in params]), axis)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def all_gather_rows(mesh: GpMesh, x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """The processes' row blocks of x (equal shapes) joined in process order
    on every process (td of a dp-sharded batch, in batch order)."""
    return torch.cat(_all_gather(mesh, x, axis))


# ---------------------------------------------------------- node tensors


def split_nodes(mesh: GpMesh, x: torch.Tensor) -> List[torch.Tensor]:
    """A node vector or matrix [n, ...] (n a multiple of gp, the same on
    every process) as the row pieces of the shards held here, piece i on
    its shard's device (a view where x is there)."""
    if x.shape[0] % mesh.gp:
        raise ValueError(f"{x.shape[0]} rows do not split into gp={mesh.gp} shards")
    chunks = torch.chunk(x, mesh.gp)
    return [_to(chunks[i], d) for i, d in zip(mesh.local, mesh.devices)]


def gather_nodes(mesh: GpMesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """All shards' row pieces joined in shard order, on the first held
    shard's device: on every process, with the same bits."""
    mine = torch.cat([_to(p, mesh.home) for p in parts])
    return torch.cat(_all_gather(mesh, mine)) if mesh.spans else mine


def gather_rows(mesh: GpMesh, parts: Sequence[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for the node tensor x whose row pieces are `parts` (equal
    lengths), on the first shard's device: each shard gives the rows it owns
    and the rows are put back in idx's order.  Differentiable in parts.  A
    mesh that spans processes has no process holding every row: own_rows
    gives each process its share."""
    if mesh.spans:
        raise ValueError("gather_rows needs every shard in this process: use own_rows")
    rows, where = own_rows(mesh, parts, idx)
    return rows[torch.argsort(where)]


def own_rows(mesh: GpMesh, parts: Sequence[torch.Tensor], idx: torch.Tensor):
    """(rows, pos): the rows x[idx] that the shards held here own, on the
    first held shard's device, and their positions in idx.  Differentiable
    in parts."""
    home = mesh.home
    idx = idx.to(home).long()
    n_local = parts[0].shape[0]
    owner = torch.div(idx, n_local, rounding_mode="floor")
    rows, where = [], []
    for i, p in zip(mesh.local, parts):
        pos = torch.nonzero(owner == i).flatten()
        rows.append(_to(p[_to(idx[pos] - i * n_local, p.device)], home))
        where.append(pos)
    return torch.cat(rows), torch.cat(where)


def ring_halos(mesh: GpMesh, parts: Sequence[torch.Tensor], width: int):
    """(left, right) halo lists over the held shards: left[i] is the last
    `width` rows of the shard before, right[i] the first `width` rows of the
    shard after, with the ring wrapping around (shard 0's left halo is the
    last shard's tail), on the shard's device.  Between processes each sends
    its last shard's tail to the next process and its first shard's head to
    the one before (batch_isend_irecv)."""
    devs, n = mesh.devices, len(parts)
    left = [parts[i - 1][-width:] for i in range(n)]
    right = [parts[(i + 1) % n][:width] for i in range(n)]
    if mesh.spans:
        left[0], right[-1] = _exchange(mesh, parts[-1][-width:], parts[0][:width])
    return [_to(x, d) for x, d in zip(left, devs)], [_to(x, d) for x, d in zip(right, devs)]


def _exchange(mesh: GpMesh, tail: torch.Tensor, head: torch.Tensor):
    """(the previous process's tail, the next process's head)."""
    n, me, group, peer = _axis(mesh, "gp")
    nxt, prv = peer((me + 1) % n), peer((me - 1) % n)
    t, h = _wire(mesh, tail), _wire(mesh, head)
    got_t, got_h = torch.empty_like(t), torch.empty_like(h)
    # tags tell the two messages apart where prev and next are one process
    # (gloo); NCCL matches a peer's messages in the order they are posted
    ops = [dist.P2POp(dist.isend, t, nxt, group, tag=0),
           dist.P2POp(dist.isend, h, prv, group, tag=1),
           dist.P2POp(dist.irecv, got_t, prv, group, tag=0),
           dist.P2POp(dist.irecv, got_h, nxt, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got_t.to(tail.device), got_h.to(head.device)


def all_gather(mesh: GpMesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """For each held shard, all shards' pieces (equal shapes) joined in
    shard order on its device; the shards of one device share one tensor."""
    if not mesh.spans:
        return per_device(mesh, lambda dev: torch.cat([_to(p, dev) for p in parts]))
    whole = torch.cat(_all_gather(mesh, torch.cat([_to(p, mesh.home) for p in parts])))
    return per_device(mesh, lambda dev: _to(whole, dev))


def per_device(mesh: GpMesh, fn) -> List:
    """fn(device) once for each distinct device of the held shards, as a
    list over them (the shards of one device share the result)."""
    done: Dict[torch.device, object] = {}
    for dev in mesh.devices:
        if dev not in done:
            done[dev] = fn(dev)
    return [done[dev] for dev in mesh.devices]


def add_in_order(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """xs added in order, on the first one's device."""
    return functools.reduce(lambda a, b: a + b.to(a.device), xs)
