"""Training over ranks: the port's counterpart of
:mod:`tetranerf_tpu.parallel.sharding`'s ``data x model`` mesh.

JAX's data parallelism is GSPMD: a D-device step computes exactly the
one-device program on the global batch, and every part of that program that
is global over the batch (the quantile buckets' sort, the bound probes, the
occupancy EMA update, the gradient-stream budget) stays global. The port
keeps that contract: **a D-rank step is the one-rank step on the
concatenation of the data shards' rows, in data order**. Each rank feeds
only its own rows (:func:`host_batch_slice`), and the few global quantities
are assembled with the collectives of :class:`Group`.

With ``model_count = M > 1`` the ranks form JAX's ``make_mesh(model_shards=
M)`` grid, ``world / M`` data shards by ``M`` model shards: rank ``r`` has
data index ``r // M`` and model index ``r % M``. Rank ``(d, m)`` holds
columns ``[m F/M, (m+1) F/M)`` of the feature field ``[V, F]`` and RAdam's
moments of them (JAX ``state_shardings``); everything else is replicated,
and the rays are sharded over ``d`` and replicated over ``m``. Two kinds of
subgroup carry the collectives: the **model group** (the M ranks of one
data index, which hold the field's columns between them) and the **data
group** (the D ranks of one model index, which hold the same columns of
different rows).

- :meth:`Group.gather_rows`: every data shard's equal-length rows in data
  order, as one ``all_reduce(SUM)`` of a zeroed ``[D, n, ...]`` buffer in
  which each rank fills its own row. Exact for integers and floats (one
  rank adds a non-zero value to each element) and on the device under both
  NCCL and gloo (gloo has no ``all_gather`` of CUDA tensors).
- :meth:`Group.gather_columns`: the model group's column blocks side by
  side, the same way; :class:`GatherColumns` is its autograd Function, whose
  backward keeps this rank's columns of the gradient (everything after the
  gather is replicated in the model group, so each rank already holds the
  whole gradient: a sum would multiply it by M).
- :meth:`Group.reduce_grads`: one coalesced ``all_reduce(SUM)`` of the
  flattened gradients (and a few step metrics) over the data group, then a
  division by its size: the ranks of a data group get the same bits, so
  RAdam keeps their parameters bit-equal.
- :meth:`Group.all_reduce_max`: the occupancy EMA update's combine.
- :meth:`Group.broadcast_model`: model index 0's tensor on its model group
  (the live viewer's queued frames, :mod:`..viewer`).

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
from typing import Iterable, List, Optional, Sequence

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


def column_slice(num_feat: int, model_index: int, model_count: int) -> slice:
    """Model shard ``model_index``'s columns of a ``[V, num_feat]`` field:
    ``[m F/M, (m+1) F/M)``. Raises ``ValueError`` (the check of JAX
    ``state_shardings``) when ``num_feat`` does not divide by the shard
    count: replicating the field instead would quietly give every rank the
    whole field and its moments."""
    if num_feat % model_count:
        raise ValueError(
            f"field_dim={num_feat} not divisible by model_shards={model_count}"
        )
    per = num_feat // model_count
    return slice(model_index * per, (model_index + 1) * per)


def check_model_shards(world: int, model_count: int) -> None:
    """Raise ``ValueError`` unless ``world`` ranks form a grid of
    ``model_count`` model shards (JAX ``make_mesh``'s check)."""
    if model_count < 1 or world % model_count:
        raise ValueError(
            f"{world} ranks not divisible by model_shards={model_count}"
        )


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place among the ranks: ``rank`` of ``world``,
    training on ``device``, in a grid of ``world / model_count`` data shards
    by ``model_count`` model shards. ``data_pg`` and ``model_pg`` are this
    rank's data group and model group (``torch.distributed`` process
    groups); ``data_pg`` None is the default group (no model shards), and
    ``model_pg`` is None without model shards."""

    rank: int
    world: int
    device: torch.device
    model_count: int = 1
    data_pg: Optional[object] = None
    model_pg: Optional[object] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model_count

    @property
    def data_count(self) -> int:
        return self.world // self.model_count

    @property
    def model_index(self) -> int:
        return self.rank % self.model_count

    def batch_slice(self, global_batch_size: int) -> slice:
        """This rank's rows of a global batch: its data shard's."""
        return host_batch_slice(global_batch_size, self.data_index, self.data_count)

    def field_columns(self, num_feat: int) -> slice:
        """This rank's columns of a ``[V, num_feat]`` field
        (:func:`column_slice`)."""
        return column_slice(num_feat, self.model_index, self.model_count)

    def _axis(self, axis: str):
        """``(index, count, process group)`` of ``axis``: ``"data"`` (this
        rank's data group) or ``"world"``."""
        if axis == "data":
            return self.data_index, self.data_count, self.data_pg
        if axis == "world":
            return self.rank, self.world, None
        raise ValueError(f"unknown axis {axis!r}")

    def gather_rows(self, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Every ``axis`` member's ``x [n, ...]`` (equal shapes) concatenated
        in order: ``[count * n, ...]``; by default the data shards' rows in
        data order. Integer and floating dtypes only."""
        index, count, pg = self._axis(axis)
        buf = x.new_zeros((count,) + tuple(x.shape))
        buf[index] = x
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=pg)
        return buf.reshape((count * x.shape[0],) + tuple(x.shape[1:]))

    def gather_columns(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each ``x [..., f]`` of this rank's column block beside the model
        group's other blocks, in model order: ``[..., M f]`` each, with one
        ``all_reduce`` of every tensor's elements together. Floating dtypes
        only (no gradient: see :class:`GatherColumns`)."""
        flat = [x.reshape(-1) for x in xs]
        sizes = [f.numel() for f in flat]
        buf = xs[0].new_zeros((self.model_count, sum(sizes)))
        if flat:
            torch.cat(flat, out=buf[self.model_index])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.model_pg)
        outs, off = [], 0
        for x, n in zip(xs, sizes):
            part = buf[:, off:off + n].reshape((self.model_count,) + tuple(x.shape))
            outs.append(part.movedim(0, -2).reshape(
                tuple(x.shape[:-1]) + (self.model_count * x.shape[-1],)))
            off += n
        return outs

    def reduce_grads(self, params: Iterable[torch.nn.Parameter],
                     extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """Replace each gradient by its mean over the data group, with one
        ``all_reduce`` of one flat f32 buffer; ``extra`` (a small f32
        vector) rides in the same buffer and comes back summed, not
        averaged. Parameters without a gradient are left out (every rank
        runs the same code, so they agree on which). A field shard's
        gradient is its columns': the data group holds the same ones."""
        grads = [p.grad for p in params if p.grad is not None]
        parts = [g.reshape(-1) for g in grads]
        if extra is not None:
            parts.append(extra.reshape(-1).to(torch.float32))
        flat = torch.cat(parts)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.data_pg)
        i = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[i:i + n].view_as(g) / self.data_count)
            i += n
        return flat[i:] if extra is not None else None

    def all_reduce_max(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """``t`` replaced, in place, by its elementwise maximum over the
        ``axis`` group; returns it."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._axis(axis)[2])
        return t

    def broadcast_model(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` replaced, in place, by model index 0's ``t`` on every rank of
        this rank's model group; returns it."""
        dist.broadcast(t, src=self.data_index * self.model_count, group=self.model_pg)
        return t

    def barrier(self) -> None:
        """Every rank of the world."""
        if self.device.type == "cuda" and dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def check_same(self, name: str, values: torch.Tensor) -> None:
        """Raise unless every rank passed the same ``values`` (an int64
        vector): one :meth:`gather_rows` over the world."""
        every = self.gather_rows(values.reshape(1, -1).to(torch.int64), "world").cpu()
        if not bool((every == every[0]).all()):
            raise RuntimeError(
                f"ranks disagree on {name}: {every.tolist()} (rank order); "
                "every rank must build the same mesh from the same data"
            )


class GatherColumns(torch.autograd.Function):
    """:meth:`Group.gather_columns` with a gradient: ``apply(group, x_0,
    x_1, ...)`` -> the full-width ``x_j``. Everything computed from the
    gathered tensors is replicated over the model group, so every rank's
    incoming gradient is already the whole one: the backward keeps this
    rank's columns of it (a slice, not a reduce-scatter, which would
    multiply the field gradient by M)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.widths = [x.shape[-1] for x in xs]
        return tuple(group.gather_columns(list(xs)))

    @staticmethod
    def backward(ctx, *grads):
        m = ctx.group.model_index
        return (None,) + tuple(
            g[..., m * w:(m + 1) * w].contiguous() for g, w in zip(grads, ctx.widths))


def gather_columns(group: Optional[Group], xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``xs`` at full width over ``group``'s model shards (through
    :class:`GatherColumns` where autograd records); ``xs`` as they are
    without a group or model shards."""
    if group is None or group.model_count == 1:
        return list(xs)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(GatherColumns.apply(group, *xs))
    return group.gather_columns(list(xs))


def table_checksum(table: torch.Tensor) -> torch.Tensor:
    """An int64 checksum ``[shape..., weighted sum]`` of a float32 or int32
    table's bits, computed on its device."""
    bits = table.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    weights = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65521 + 1
    shape = torch.tensor(list(table.shape), dtype=torch.int64, device=bits.device)
    return torch.cat([shape, (bits * weights).sum().reshape(1)])


# How long a collective may wait for every rank. The ranks of data index 0
# alone evaluate (each eval cadence, and the whole held-out split at the
# end) while the others wait at a barrier: 200 views at 800^2 take about 10
# minutes at 250K rays/s, NCCL's default. Two hours leave a larger split
# room.
COLLECTIVE_TIMEOUT = datetime.timedelta(hours=2)


def init_distributed(device="cuda", backend: Optional[str] = None,
                     model_shards: int = 1) -> Optional[Group]:
    """Join the ranks that torchrun (or a caller that sets its environment)
    started, or return None when ``RANK`` and ``WORLD_SIZE`` are not set.

    ``device`` ``"cuda"`` puts each rank on ``cuda:LOCAL_RANK`` and takes
    NCCL; ``"cpu"`` takes gloo. A device with an index (``"cuda:0"``) puts
    every rank there, and ``backend`` overrides the choice (gloo reduces
    CUDA tensors too, through the host: two ranks can share one card).

    ``model_shards`` M > 1 arranges the ranks as ``world / M`` data shards
    by M model shards and creates every model group, then every data
    group, on every rank in the same order (``torch.distributed.new_group``
    is collective); ``ValueError`` if ``world`` does not divide by M."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    check_model_shards(world, model_shards)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=COLLECTIVE_TIMEOUT)
    if model_shards == 1:
        return Group(rank=rank, world=world, device=dev)
    m = model_shards
    model_pgs = [dist.new_group(list(range(d * m, (d + 1) * m)), timeout=COLLECTIVE_TIMEOUT)
                 for d in range(world // m)]
    data_pgs = [dist.new_group(list(range(i, world, m)), timeout=COLLECTIVE_TIMEOUT)
                for i in range(m)]
    return Group(rank=rank, world=world, device=dev, model_count=m,
                 data_pg=data_pgs[rank % m], model_pg=model_pgs[rank // m])


def destroy(group: Optional[Group]) -> None:
    """Leave the process group (a no-op without one)."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()
