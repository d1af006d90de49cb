"""Data parallelism over a ``torch.distributed`` process group
(``gansynth_tpu/parallel/sharding.py``).

The reference is one controller over every device: GSPMD with the batch
sharded on a 1-D ``data`` mesh, the state replicated, and XLA inserting
the collectives. The port is PyTorch's idiom, one process per card, in a
process group (NCCL on CUDA, gloo on the CPU):

- rank r owns rows ``[r B/W, (r+1) B/W)`` of every global batch of B
  rows over W ranks, the layout of the reference's ``P('data')``;
  ``TrainConfig.batch_size`` stays the global batch;
- the training state is replicated: every rank makes it from the same
  seed (or restores the same checkpoint), and :func:`replicate_on_mesh`
  broadcasts rank 0's and checks that the ranks agreed;
- every reduction of the step is a global-batch one, as in the reference:
  the step draws its noise for the global batch and takes its rows; the
  gradients are the mean over ranks of each rank's gradient
  (:meth:`Mesh.all_reduce_mean`, one flat bucket); the minibatch-stddev
  statistic is taken over the global batch through a differentiable
  all-gather (:meth:`Mesh.gather`). So the DP step equals the one-process
  step on the same global batch, up to the order of float sums.

The reference's ``jit_*_for_mesh`` compile the step for the mesh; the
port captures it, collectives included, into a CUDA graph on each rank
(``train/step.py``). The ranks decide together when to capture and check
together that every capture succeeded: :meth:`Mesh.any` runs on the host,
over a gloo group made beside the NCCL group, so that neither decision
makes the host wait for the card.
``make_mesh`` is a :class:`Mesh` of the current process group, and
``make_multislice_mesh`` the same ranks grouped (replica, data), whose
gradient all-reduce runs inside each data group and then across
replicas. The wrapper ``DistributedDataParallel`` is not used: the step
takes its gradients with ``torch.autograd.grad`` and differentiates the
critic twice for the gradient penalty, which the wrapper does not
support.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# What a launcher (torchrun's env://) sets for each process.
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group: ``rank`` of
    ``world`` ranks, its ``device``, and for a (replica, data) grouping
    the subgroup of its data axis and of its replica axis (``None`` on a
    1-D mesh). ``grouped``: the mesh is a process group's
    (:func:`make_mesh`), whose collectives run also at one rank (a
    one-card NCCL run goes through them); a mesh made by hand without a
    group must have one rank, and runs none. ``host_group``: the gloo
    group of the host's own collectives beside an NCCL group (``None``:
    the default group, gloo already)."""

    rank: int
    world: int
    device: torch.device
    data_group: Optional[object] = None
    replica_group: Optional[object] = None
    grouped: bool = False
    host_group: Optional[object] = None

    def __post_init__(self):
        if self.world > 1 and not self.grouped:
            raise ValueError("a mesh of several ranks needs a process group "
                             "(make_mesh)")

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        if n % self.world:
            raise ValueError(f"global batch {n} must divide the world size "
                             f"{self.world}")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the mean of ``t`` over the ranks. On a (replica, data)
        grouping the sum runs inside the data group, then across the
        replicas."""
        if self.grouped:
            if self.data_group is None:
                dist.all_reduce(t)
            else:
                dist.all_reduce(t, group=self.data_group)
                dist.all_reduce(t, group=self.replica_group)
            t.div_(self.world)
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the sum of ``t`` over the ranks."""
        if self.grouped:
            dist.all_reduce(t)
        return t

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on one of them (the
        reference's ``process_allgather(...).max()``), agreed on the host:
        the card's stream is not waited for."""
        if not self.grouped:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of a batch-sharded tensor: every rank's rows in
        rank order, differentiable to any order (the backward of the
        gather is the sum over ranks of the gradient, sliced to the rank's
        rows, and the backward of that is the gather again)."""
        return _Gather.apply(x, self)


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _SumSlice.apply(g, ctx.mesh), None


class _SumSlice(torch.autograd.Function):
    """The gradient of the gather: sum the full-batch gradient over the
    ranks and keep this rank's rows."""

    @staticmethod
    def forward(ctx, g, mesh):
        ctx.mesh = mesh
        total = g.contiguous().clone()
        dist.all_reduce(total)
        return total[mesh.rows(total.shape[0])].contiguous()

    @staticmethod
    def backward(ctx, gg):
        return _Gather.apply(gg, ctx.mesh), None


def launched() -> bool:
    """True when a launcher (``torchrun``) started this process: its
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` are set."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def world_size(device: torch.device) -> int:
    """The data-parallel width a run on ``device`` takes: the current
    group's, else the launcher's ``WORLD_SIZE``, else the visible cards
    for CUDA (one worker per card) and 1 for the CPU."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return torch.cuda.device_count() if device.type == "cuda" else 1


def initialize_multihost(device: torch.device,
                         init_method: str = "env://",
                         rank: Optional[int] = None,
                         world: Optional[int] = None) -> None:
    """Join the process group (the counterpart of
    ``jax.distributed.initialize``): NCCL for CUDA, gloo for the CPU.
    Under a launcher the address, rank and world size come from its
    environment; otherwise pass ``init_method`` (``tcp://host:port``),
    ``rank`` and ``world``. A CUDA process binds to card ``LOCAL_RANK``
    (default: its rank modulo the visible cards)."""
    if dist.is_initialized():
        return
    if device.type == "cuda":
        own = rank if rank is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", own % max(torch.cuda.device_count(), 1))))
    kwargs = {}
    if rank is not None:
        kwargs.update(rank=rank, world_size=world)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, **kwargs)


def make_mesh(device: Optional[torch.device] = None) -> Mesh:
    """The 1-D data mesh of the current process group. The process's
    device is its current card (or the CPU under gloo). Raises when no
    group is set up: data parallelism never runs alone on one rank by
    default. Every rank must call this (beside NCCL it creates the host's
    gloo group)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "data parallelism needs a process group: run under a launcher "
            "(torchrun) or call initialize_multihost first")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    host = None if dist.get_backend() == "gloo" else dist.new_group(
        backend="gloo")
    return Mesh(dist.get_rank(), dist.get_world_size(), torch.device(device),
                grouped=True, host_group=host)


def make_multislice_mesh(num_slices: int,
                         device: Optional[torch.device] = None) -> Mesh:
    """The ranks grouped (replica, data): ``num_slices`` data groups of
    consecutive ranks. The batch still shards over all ranks in rank
    order, so the step is the 1-D mesh's; only the gradient all-reduce is
    hierarchical. Every rank must call this (it creates the subgroups)."""
    mesh = make_mesh(device)
    if mesh.world % num_slices:
        raise ValueError(f"{mesh.world} ranks do not divide {num_slices} "
                         "slices")
    per = mesh.world // num_slices
    data_group = replica_group = None
    for s in range(num_slices):   # every rank creates every group
        g = dist.new_group(list(range(s * per, (s + 1) * per)))
        if mesh.rank // per == s:
            data_group = g
    for i in range(per):
        g = dist.new_group(list(range(i, mesh.world, per)))
        if mesh.rank % per == i:
            replica_group = g
    return dataclasses.replace(mesh, data_group=data_group,
                               replica_group=replica_group)


def cache_sharding(layout: str) -> str:
    """The placement of the ``--device-cache`` dataset: ``"replicate"`` (a
    full copy on every rank, the batch gathered locally) or ``"shard"``
    (rank r holds examples ``[r N/W, (r+1) N/W)``; a batch's rows come
    from their owners in one collective a step). See
    ``TrainConfig.device_cache_layout``."""
    if layout not in ("replicate", "shard"):
        raise ValueError(f"unknown device_cache_layout {layout!r}")
    return layout


def shard_train_inputs(mesh: Mesh, wave, pitch):
    """This rank's rows of a global batch (numpy or tensors), on its
    device. The global batch must divide the world size. (The reference's
    ``shard_host_local_batch`` and ``shard_host_local_chunk`` assemble a
    global array from each process's slice under ``--multihost``; here a
    rank's slice is already all it needs: :func:`rank_rows`.)"""
    rows = mesh.rows(wave.shape[0])
    return (torch.as_tensor(np.asarray(wave[rows]), dtype=torch.float32,
                            device=mesh.device),
            torch.as_tensor(np.asarray(pitch[rows]), dtype=torch.int32,
                            device=mesh.device))


def rank_rows(mesh: Mesh, array: np.ndarray, global_batch: int,
              axis: int = 0) -> np.ndarray:
    """This rank's part of a batch (or a ``[K, B, ...]`` chunk along
    ``axis`` 1): the rank's rows of a batch of the global size; a batch of
    the local size (``--multihost``, where each process decodes only its
    slice) as it is."""
    if array.shape[axis] != global_batch:
        return array
    rows = mesh.rows(global_batch)
    return array[rows] if axis == 0 else array[:, rows]


def _state_tensors(state) -> List[torch.Tensor]:
    tensors = []
    for module in (state.g, state.d, state.ema):
        tensors += [t.data for t in module.state_dict().values()]
    for opt in (state.g_opt, state.d_opt):
        for st in opt.state.values():
            tensors += [v for v in st.values() if torch.is_tensor(v)]
    return tensors


@torch.no_grad()
def replicate_on_mesh(mesh: Mesh, state):
    """The state replicated: every rank made it from the same seed or
    checkpoint, so rank 0's weights, Adam moments, counts, key and step
    are broadcast and held to each rank's own; a difference on any rank
    raises on every rank (a run must not go on from states that
    disagree)."""
    if mesh.world == 1:
        return state
    tensors = _state_tensors(state)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    ints = torch.tensor([state.step, *state.rng, state.g_opt.count,
                         state.d_opt.count, len(tensors)],
                        dtype=torch.int64, device=mesh.device)
    ref, ref_ints = flat.clone(), ints.clone()
    dist.broadcast(ref, 0)
    dist.broadcast(ref_ints, 0)
    off = torch.stack([(flat - ref).abs().max(),
                       (ints - ref_ints).abs().max().float()])
    dist.all_reduce(off, op=dist.ReduceOp.MAX)
    if float(off.max()) != 0.0:
        raise RuntimeError(
            f"the ranks made different training states (max difference "
            f"{off.tolist()} in weights, in step/key/count); every rank "
            "must start from the same seed or checkpoint")
    return state


def devices_for(device: torch.device) -> Sequence[torch.device]:
    """Every visible card for CUDA (``serve --data-parallel``), the CPU
    once for the CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]
