"""Data-parallel training over ranks: the port's counterpart of
:mod:`tetranerf_tpu.parallel.sharding`'s data axis.

JAX's data parallelism is GSPMD: a D-device step computes exactly the
one-device program on the global batch, and every part of that program that
is global over the batch (the quantile buckets' sort, the bound probes, the
occupancy EMA update, the gradient-stream budget) stays global. The port
keeps that contract: **a D-rank step is the one-rank step on the
concatenation of the ranks' rows, in rank order**. Each rank feeds only its
own rows (:func:`host_batch_slice`), and the few global quantities are
assembled with the collectives of :class:`Group`:

- :meth:`Group.gather_rows`: every rank's equal-length rows in rank order,
  as one ``all_reduce(SUM)`` of a zeroed ``[world, n, ...]`` buffer in
  which each rank fills its own row. Exact for integers and floats (one
  rank adds a non-zero value to each element) and on the device under both
  NCCL and gloo (gloo has no ``all_gather`` of CUDA tensors).
- :meth:`Group.reduce_grads`: one coalesced ``all_reduce(SUM)`` of the
  flattened gradients (and a few step metrics), then a division by the
  world size: every rank gets the same bits, so RAdam keeps the ranks'
  parameters bit-equal.
- :meth:`Group.all_reduce_max`: the occupancy EMA update's combine.

The model is not wrapped in ``DistributedDataParallel``: the train forward
is ``TetraNerf.get_outputs``, the appearance embedding is unused without
camera indices, and the field's dense ``[V, F]`` gradient reduces as well in
one flat buffer as in buckets.

:func:`init_distributed` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); without it
there is no group and every code path is the one-process path.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist


def host_batch_slice(global_batch_size: int, process_index: int,
                     process_count: int) -> slice:
    """Rank ``process_index``'s contiguous slice of every globally indexed
    ray batch: rows ``[p*G/P, (p+1)*G/P)`` (a copy of
    :func:`tetranerf_tpu.parallel.sharding.host_batch_slice`, with the
    rank and world passed in). ``global_batch_size`` must divide evenly by
    the rank count."""
    if global_batch_size % process_count:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{process_count} processes"
        )
    per = global_batch_size // process_count
    return slice(process_index * per, (process_index + 1) * per)


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place among the ranks (the default process group):
    ``rank`` of ``world``, training on ``device``."""

    rank: int
    world: int
    device: torch.device

    def batch_slice(self, global_batch_size: int) -> slice:
        return host_batch_slice(global_batch_size, self.rank, self.world)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x [n, ...]`` (equal shapes) concatenated in rank
        order: ``[world * n, ...]``. Integer and floating dtypes only."""
        buf = x.new_zeros((self.world,) + tuple(x.shape))
        buf[self.rank] = x
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        return buf.reshape((self.world * x.shape[0],) + tuple(x.shape[1:]))

    def reduce_grads(self, params: Iterable[torch.nn.Parameter],
                     extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """Replace each gradient by its mean over the ranks, with one
        ``all_reduce`` of one flat f32 buffer; ``extra`` (a small f32
        vector) rides in the same buffer and comes back summed, not
        averaged. Parameters without a gradient are left out (every rank
        runs the same code, so they agree on which)."""
        grads = [p.grad for p in params if p.grad is not None]
        parts = [g.reshape(-1) for g in grads]
        if extra is not None:
            parts.append(extra.reshape(-1).to(torch.float32))
        flat = torch.cat(parts)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        i = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[i:i + n].view_as(g) / self.world)
            i += n
        return flat[i:] if extra is not None else None

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` replaced, in place, by its elementwise maximum over the
        ranks; returns it."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    def barrier(self) -> None:
        if self.device.type == "cuda" and dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def check_same(self, name: str, values: torch.Tensor) -> None:
        """Raise unless every rank passed the same ``values`` (an int64
        vector): one :meth:`gather_rows`."""
        every = self.gather_rows(values.reshape(1, -1).to(torch.int64)).cpu()
        if not bool((every == every[0]).all()):
            raise RuntimeError(
                f"ranks disagree on {name}: {every.tolist()} (rank order); "
                "every rank must build the same mesh from the same data"
            )


def table_checksum(table: torch.Tensor) -> torch.Tensor:
    """An int64 checksum ``[shape..., weighted sum]`` of a float32 or int32
    table's bits, computed on its device."""
    bits = table.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    weights = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65521 + 1
    shape = torch.tensor(list(table.shape), dtype=torch.int64, device=bits.device)
    return torch.cat([shape, (bits * weights).sum().reshape(1)])


# How long a collective may wait for every rank. Rank 0 alone evaluates
# (each eval cadence, and the whole held-out split at the end) while the
# others wait at a barrier: 200 views at 800^2 take about 10 minutes at
# 250K rays/s, NCCL's default. Two hours leave a larger split room.
COLLECTIVE_TIMEOUT = datetime.timedelta(hours=2)


def init_distributed(device="cuda", backend: Optional[str] = None) -> Optional[Group]:
    """Join the ranks that torchrun (or a caller that sets its environment)
    started, or return None when ``RANK`` and ``WORLD_SIZE`` are not set.

    ``device`` ``"cuda"`` puts each rank on ``cuda:LOCAL_RANK`` and takes
    NCCL; ``"cpu"`` takes gloo. A device with an index (``"cuda:0"``) puts
    every rank there, and ``backend`` overrides the choice (gloo reduces
    CUDA tensors too, through the host: two ranks can share one card)."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=COLLECTIVE_TIMEOUT)
    return Group(rank=rank, world=world, device=dev)


def destroy(group: Optional[Group]) -> None:
    """Leave the process group (a no-op without one)."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()
