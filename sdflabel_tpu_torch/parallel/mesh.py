"""The (data, rays) layout of the ranks, over torch.distributed.

Counterpart of sdflabel_tpu/parallel/mesh.py. JAX lays its devices out as
one logical program over a jax.sharding.Mesh with the axes 'data' (crops,
frames, the batch) and 'rays' (pixels within a crop). Here each device is
one process (a rank) under torch.distributed -- NCCL on the card, gloo on
the CPU -- and the mesh is the ranks laid out row-major as (data, rays):
rank r sits at data index r // n_rays and rays index r % n_rays. Each
axis has its process groups: the ranks that share a rays index form a
data group, and those that share a data index a rays group. The train
steps (engine/css_train.py, engine/deepsdf_train.py) reduce over the
data group, the batched refine (parallel/batched_refine.py) gathers its
crops over it, and the pixel-sharded render and refine (parallel/rays.py,
parallel/sharded_refine.py) work over the rays group.

The differentiable collectives keep one convention for cotangents. A
value every rank holds whole and uses in the same computation (a loss, a
parameter before it enters a rank's share of the work) has the same
cotangent on every rank; a value of one rank's share (its pixel block,
its slice of points, its partial sum) has that rank's own. Each of the
three collectives has the backward that follows from it: ``all_gather``
(shares -> whole; backward: this rank's slice), ``sum_to_replicated``
(partial sums -> whole; backward: the identity) and ``from_replicated``
(a whole value entering each rank's own share; backward: the sum of the
ranks' cotangents). A whole value that feeds each rank's share therefore
goes through ``from_replicated``; its gradient then comes out the same,
and complete, on every rank, as JAX's shard_map transpose gives it.
``all_reduce_sum`` sums on both passes, for statistics every rank's loss
depends on (the data-parallel BatchNorm).

Frame partitioning per process (the reference's mpirun pattern,
rotate_iou.py:10-14) is :func:`process_frame_subset`.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, rays) layout of the world's ranks.
    ``shape`` maps each axis to its size, ``size`` is the world size;
    ``data_group`` / ``rays_group`` are this rank's process groups along
    each axis (None when the world is one process that never initialized
    torch.distributed)."""

    shape: dict
    rank: int
    data_index: int
    rays_index: int
    data_group: object = None
    rays_group: object = None

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["rays"]


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_data: int | None = None, n_rays: int = 1) -> Mesh:
    """Lay the world's ranks out as (data, rays) and build each axis's
    process groups (every rank calls this, in the same order, as
    torch.distributed.new_group requires)."""
    rank, n = world()
    if n_data is None:
        n_data = n // n_rays
    if n_data * n_rays != n:
        raise ValueError(f"mesh {n_data}x{n_rays} != {n} devices")
    mesh = Mesh({"data": n_data, "rays": n_rays}, rank, rank // n_rays,
                rank % n_rays)
    if not (dist.is_available() and dist.is_initialized()):
        return mesh
    for j in range(n_rays):
        group = dist.new_group([i * n_rays + j for i in range(n_data)])
        if j == mesh.rays_index:
            mesh.data_group = group
    for i in range(n_data):
        group = dist.new_group([i * n_rays + j for j in range(n_rays)])
        if i == mesh.data_index:
            mesh.rays_group = group
    return mesh


def default_backend(device=None) -> str:
    """NCCL for the card, gloo for the CPU."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Join the process group (NCCL with a card, else gloo): from an
    explicit ``host:port``, world size and rank, or from the environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them).
    Without either it prints and stays single-process, as the JAX
    package's does."""
    backend = default_backend()
    try:
        if coordinator_address is not None:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id)
        elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                           "WORLD_SIZE", "RANK")):
            dist.init_process_group(backend, init_method="env://")
        else:
            raise ValueError("no coordinator address and no MASTER_ADDR / "
                             "WORLD_SIZE / RANK in the environment")
    except (RuntimeError, ValueError) as e:
        print(f"torch.distributed not initialized ({e}); "
              "single-process mode")


def process_frame_subset(num_frames: int) -> range:
    """The frames of this process: a contiguous share by rank."""
    rank, n = world()
    per = (num_frames + n - 1) // n
    return range(rank * per, min((rank + 1) * per, num_frames))


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; its VJP sums the cotangents the same way (each
    rank's loss depends on every rank's input through the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of `group`."""
    return _AllReduceSum.apply(x, group)


class _SumToReplicated(torch.autograd.Function):
    """Sum over the group; the sum is whole on every rank, so its
    cotangent is too, and each partial's cotangent is that one."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_to_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of the ranks' partials `x`, whole on every rank;
    its backward is the identity."""
    return _SumToReplicated.apply(x, group)


class _FromReplicated(torch.autograd.Function):
    """The identity; the backward sums the ranks' cotangents, each the
    part of the gradient that one rank's share of the work gives."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def from_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, held whole on every rank, as it enters this rank's share of the
    work: the gradient that reaches it is the sum over the ranks."""
    return _FromReplicated.apply(x, group)


class _AllGather(torch.autograd.Function):
    """Concatenate the ranks' `x` along dim 0, in rank order; the backward
    takes this rank's slice of the whole (same on every rank)
    cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather along dim 0 (every rank's `x` has the same
    shape); gloo and NCCL alike. Bool tensors travel as uint8."""
    if x.dtype == torch.bool:
        return _AllGather.apply(x.to(torch.uint8), group).bool()
    return _AllGather.apply(x, group)


def all_reduce_(tensors: list[torch.Tensor], group) -> None:
    """Sum each tensor over `group` in place, in one flat collective."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def data_slice(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous share of a global batch of `n` along the
    data axis (JAX's P('data') sharding); `n` must divide."""
    k = mesh.shape["data"]
    if n % k:
        raise ValueError(f"batch {n} does not divide over the mesh "
                         f"({k} data shards)")
    per = n // k
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def _rank_entry(rank: int, fn, world_size: int, port: int, backend: str,
                args: tuple) -> None:
    # a rank that cannot join raises: it never trains alone
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args: tuple = (),
                backend: str | None = None) -> None:
    """Run ``fn(rank, *args)`` in `world_size` new processes (the 'spawn'
    start method: a rank never inherits a CUDA context), each in a process
    group of them all on a free localhost port; returns when every rank
    has, and raises if one failed. `fn` must be importable by name."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_entry, nprocs=world_size, join=True,
             args=(fn, world_size, free_port(), backend or default_backend(),
                   args))
