"""Entry walk and neighbour march: kernel K1 (``csrc/march.cu``) and its
twin; the point-location walk: kernel K9 (``csrc/march.cu``) and its twin.

Counterpart of ``_walk_packed`` and ``march_features`` (``hops=1``) in
:mod:`tetranerf_tpu.ops.fused`. The outputs keep that module's fields and
layouts (:class:`FusedMarch`, :class:`MarchStream`).

With the empty-space skip grid (a mesh carrying ``skip_table``, see
:mod:`.skip_grid`, and occupancy termination on) a prologue sphere-traces
each ray from its hull entry before the entry walk: up to 64 times it reads
the safe advance ``rho`` of the voxel it is in and moves by it, until
``rho`` is 0 or it leaves the hull. A ray that leaves the hull is dropped
(``hit`` false); a ray that moved starts its entry walk from its voxel's
anchor cell, at the point where it stopped.

For each ray the march walks from the hull-entry seed to the cell holding
the entry point, then steps cell to neighbour through the exit face. Each
step emits one interval ``[t0, t1]`` with its exit barycentrics and updates
the ray's deduplicated vertex stream: a face-adjacent step shares three of
its four vertices with the previous cell, so a step adds at most one new
vertex (``new_vid``), and ``pos`` maps the cell's four vertices to their
positions in the stream. With occupancy, the ray accumulates
``occupancy[cell] * chord`` and stops once that optical depth passes the
cap. A ray stops at its own end; slots after it keep the padding
``cells=-1``, ``t0=t1=+inf``, ``bary=pos=new_vid=0``.

One K1 launch writes every output in its final layout, padding included;
:func:`march` is the hull slab and that launch.

The JAX march runs its steps in blocks of ``min(16, max_steps)``, so a ray
may take up to the block-rounded step count before its ``done`` flag is
read, while only the first ``max_steps`` intervals are kept. Both
versions here reproduce that: they step ``num_steps`` times and emit the
first ``max_steps``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import cuda
from .traversal import BARY_EPS, eval_planes, hull_intersect


class MarchStream(NamedTuple):
    """Geometry that turns a field into endpoint features for one march."""

    vids: torch.Tensor  # i32[R, T+4] per-ray deduplicated vertex ids
    pos: torch.Tensor  # i32[R, T+1, 4] endpoint -> stream positions
    bary: torch.Tensor  # f32[R, T+1, 4] endpoint barycentric weights


class FusedMarch(NamedTuple):
    """Sorted traversal intervals of a batch of rays.

    Interval ``k`` of ray ``r`` spans ``[t0[r, k], t1[r, k]]`` in cell
    ``cells[r, k]``; invalid slots have ``cells=-1`` and ``t0=t1=+inf``.
    ``feats[:, 0]`` is the feature at the entry point and ``feats[:, k+1]``
    the feature at the exit of interval ``k``."""

    cells: torch.Tensor  # i32[R, T]
    t1: torch.Tensor  # f32[R, T]
    t_entry: torch.Tensor  # f32[R]
    valid: torch.Tensor  # bool[R, T]
    num_valid: torch.Tensor  # i32[R]
    feats: Optional[torch.Tensor]  # f32[R, T+1, F]
    hit: torch.Tensor  # bool[R]
    overflow: torch.Tensor  # bool[R]: step bound reached while marching
    stream: Optional[MarchStream] = None
    t0s: Optional[torch.Tensor] = None  # f32[R, T]

    @property
    def t0(self):
        if self.t0s is not None:
            return self.t0s
        return torch.cat([self.t_entry[:, None], self.t1[:, :-1]], dim=1)


def _first_min(x):
    """Row-wise ``(min, argmin)`` over 4 columns, first index on ties."""
    best = x[:, 0]
    idx = torch.zeros_like(best, dtype=torch.int64)
    for j in range(1, x.shape[1]):
        take = x[:, j] < best
        best = torch.where(take, x[:, j], best)
        idx = torch.where(take, j, idx)
    return best, idx


def _fetch(table_i, c):
    """Packed rows of cells ``c`` (clamped at 0), read through the int view
    so the bit-cast id columns are copied as bits."""
    row = table_i[c.clamp_min(0).long()]
    planes = row[:, :16].view(torch.float32).reshape(-1, 4, 4)
    return planes, row[:, 16:20], row[:, 20:24], row[:, 24].view(torch.float32)


def locate_points_twin(table, seeds, points, steps: int, return_rows: bool = False):
    """Plain PyTorch version of K9 (any device; JAX ``_walk_packed``): from
    cell ``seeds i32[N]`` walk ``points f32[N, 3]`` toward the most negative
    barycentric, for at most ``steps`` steps, until the cell holds the
    point. Returns the cell where each walk stopped, -1 once it walked out
    of the hull (a negative seed stays as it is). ``return_rows`` also
    returns the rows each walk read before it stopped."""
    table_i = table.view(torch.int32)
    c = seeds
    done = c < 0
    rows = torch.zeros_like(c)
    for _ in range(steps):
        if not bool((~done).any()):
            break
        planes, nb, _, _ = _fetch(table_i, c)
        b_min, k = _first_min(eval_planes(planes, points))
        inside = b_min >= -BARY_EPS
        nxt = nb.gather(1, k[:, None])[:, 0]
        rows += (~done).to(rows.dtype)
        c = torch.where(done | inside, c, nxt)
        done = done | inside | (nxt < 0)
    return (c, rows) if return_rows else c


def _locate_cuda(table, seeds, points, steps):
    cuda.check_cuda_inputs("locate", table=table, seeds=seeds, points=points)
    n = seeds.shape[0]
    if (table.dtype != torch.float32 or table.shape[1] != 64
            or seeds.dtype != torch.int32 or points.shape != (n, 3)
            or points.dtype != torch.float32):
        raise ValueError("locate: unexpected input shapes or dtypes")
    out = torch.empty(n, dtype=torch.int32, device=seeds.device)
    if n:
        cuda.launch("locate", "tetranerf_locate", seeds.device,
                    cuda.ptr(table), cuda.ptr(seeds), cuda.ptr(points), n, int(steps),
                    cuda.ptr(out))
    return out


def locate_points(table, seeds, points, steps: int):
    """K9 on CUDA tensors, :func:`locate_points_twin` on CPU tensors."""
    if points.is_cuda:
        return _locate_cuda(table, seeds, points, steps)
    if points.device.type == "cpu":
        return locate_points_twin(table, seeds, points, steps)
    raise ValueError(f"locate: unsupported device {points.device}")


SKIP_TRACE_STEPS = 64


def _voxel(skip_meta, grid: int, o, d, t):
    """Flat index of the skip-grid voxel holding ``o + t d``, clamped into
    the grid (``(int)`` truncates toward zero, as ``astype(int32)``)."""
    p = o + t[:, None] * d
    ij = ((p - skip_meta[None, :3]) * skip_meta[None, 3:6]).to(torch.int32)
    ij = ij.clamp(0, grid - 1).long()
    return (ij[:, 0] * grid + ij[:, 1]) * grid + ij[:, 2]


def _skip_trace(skip_table, skip_meta, o, d, t_in, eps_t, t_cap, hit, seed):
    """The sphere-trace prologue (JAX ``march_features``, ``use_skip``):
    returns ``(t_loc, hit, seed)`` for the entry walk."""
    grid = skip_table.shape[0]
    rows = skip_table.reshape(-1, 8)
    t = t_in + eps_t
    moving = hit
    for _ in range(SKIP_TRACE_STEPS):
        if not bool(moving.any()):
            break
        rho = rows[_voxel(skip_meta, grid, o, d, t), 0]
        adv = moving & (rho > 0.0)
        t = torch.where(adv, t + rho, t)
        moving = adv & (t < t_cap)
    # A ray whose trace left the hull crossed only free space: dropped.
    hit = hit & (t < t_cap)
    anchor = rows.view(torch.int32)[_voxel(skip_meta, grid, o, d, torch.minimum(t, t_cap)), 1]
    skipped = t > t_in + eps_t
    seed = torch.where(~hit, -1, torch.where(skipped & (anchor >= 0), anchor, seed))
    return t, hit, seed


def _crossings(planes, t, o, d):
    p = o + t[:, None] * d
    b = eval_planes(planes, p)
    den = (
        planes[..., 0] * d[:, None, 0] + planes[..., 1] * d[:, None, 1]
    ) + planes[..., 2] * d[:, None, 2]
    inf = torch.tensor(float("inf"), device=den.device)
    t_cross = t[:, None] - b / torch.where(den == 0.0, inf, den)
    return b, den, t_cross


def march_intervals_twin(
    table, hull_cells, origins, directions, t_in, t_out, entry_facet, hit,
    max_steps: int, num_steps: int, walk_steps: int,
    use_occupancy: bool, depth_cap: float, skip_table=None, skip_meta=None,
) -> FusedMarch:
    """Plain PyTorch version of K1 (any device): every ray steps in lock
    step until all are done; :func:`march`'s outputs without ``feats``.
    With ``skip_table`` (and ``skip_meta``) the sphere-trace prologue runs
    before the entry walk."""
    dev = origins.device
    num_rays = origins.shape[0]
    inf = torch.tensor(float("inf"), device=dev)
    table_i = table.view(torch.int32)
    o, d = origins, directions

    span = torch.maximum(t_out - t_in, torch.tensor(1e-30, device=dev))
    eps_t = 1e-3 * span + 1e-7
    t_cap = t_out + eps_t
    t_loc = t_in + eps_t
    seed = torch.where(hit, hull_cells[entry_facet.long()], -1)
    if skip_table is not None:
        t_loc, hit, seed = _skip_trace(skip_table, skip_meta, o, d, t_in, eps_t,
                                       t_cap, hit, seed)

    # Entry walk: step toward the most negative barycentric until inside.
    c = locate_points_twin(table, seed, o + t_loc[:, None] * d, walk_steps)
    hit = hit & (c >= 0)

    planes0, _, vids0, _ = _fetch(table_i, c)
    b0, den0, tc0 = _crossings(planes0, t_loc, o, d)
    t_entry = torch.amax(torch.where(den0 > 0.0, tc0, -inf), dim=-1)
    t_entry = torch.where(torch.isfinite(t_entry), t_entry, t_loc)
    bary_entry = b0 + (t_entry - t_loc)[:, None] * den0

    T = max_steps
    cells = torch.full((num_rays, T), -1, dtype=torch.int32, device=dev)
    t0s = torch.full((num_rays, T), float("inf"), device=dev)
    t1s = torch.full((num_rays, T), float("inf"), device=dev)
    barys = torch.zeros((num_rays, T, 4), device=dev)
    poss = torch.zeros((num_rays, T, 4), dtype=torch.int32, device=dev)
    new_vids = torch.zeros((num_rays, T), dtype=torch.int32, device=dev)

    t = t_entry
    done = ~hit
    vids_prev = vids0
    pos_prev = torch.arange(4, dtype=torch.int32, device=dev).expand(num_rays, 4)
    depth = torch.zeros(num_rays, device=dev)
    for step in range(num_steps):
        if bool(done.all()):
            break
        planes, nb, vids_cur, occ = _fetch(table_i, c)
        b, den, t_cross = _crossings(planes, t, o, d)
        t_raw, k_exit = _first_min(torch.where(den < 0.0, t_cross, inf))
        found = torch.isfinite(t_raw)
        t_exit = torch.maximum(t_raw, t)
        bary_exit = b + (t_exit - t)[:, None] * den
        nxt = nb.gather(1, k_exit[:, None])[:, 0]
        valid = ~done & found & (c >= 0)
        new_done = done | ~found | (nxt < 0) | (t_exit >= t_cap)
        new_t = torch.where(valid, t_exit, t)
        if use_occupancy:
            depth = depth + torch.where(valid, occ * (new_t - t), 0.0)
            new_done = new_done | (depth > depth_cap)
        eq = vids_cur[:, :, None] == vids_prev[:, None, :]
        is_new = ~eq.any(dim=-1)
        matched = (eq * pos_prev[:, None, :]).sum(dim=-1).to(torch.int32)
        pos_cur = torch.where(is_new, 4 + step, matched).to(torch.int32)
        new_vid = torch.where(is_new, vids_cur, 0).sum(dim=-1).to(torch.int32)
        if step < T:
            cells[:, step] = torch.where(valid, c, -1)
            t1s[:, step] = torch.where(valid, t_exit, inf)
            t0s[:, step] = torch.where(valid, t, inf)
            barys[:, step] = torch.where(valid[:, None], bary_exit, 0.0)
            poss[:, step] = torch.where(valid[:, None], pos_cur, 0)
            new_vids[:, step] = torch.where(valid, new_vid, 0)
        c = torch.where(valid, nxt, c)
        t = new_t
        done = new_done
        vids_prev = vids_cur
        pos_prev = pos_cur
    valid = cells >= 0
    num_valid = valid.sum(dim=-1).to(torch.int32)
    hit = hit & (num_valid > 0)
    pos0 = torch.arange(4, dtype=torch.int32, device=dev).expand(num_rays, 1, 4)
    bary_entry = torch.where(hit[:, None], bary_entry, 0.0)
    return FusedMarch(
        cells=cells, t1=t1s, t_entry=t_entry, valid=valid, num_valid=num_valid,
        feats=None, hit=hit, overflow=hit & ~done,
        stream=MarchStream(
            vids=torch.cat([vids0, new_vids], dim=1),
            pos=torch.cat([pos0, poss], dim=1),
            bary=torch.cat([bary_entry[:, None], barys], dim=1),
        ),
        t0s=t0s,
    )


def _march_cuda(
    table, hull_cells, origins, directions, t_in, t_out, entry_facet, hit,
    max_steps, num_steps, walk_steps, use_occupancy, depth_cap,
    skip_table=None, skip_meta=None,
) -> FusedMarch:
    grid = {} if skip_table is None else dict(skip_table=skip_table, skip_meta=skip_meta)
    cuda.check_cuda_inputs(
        "march", table=table, hull_cells=hull_cells, origins=origins,
        directions=directions, t_in=t_in, t_out=t_out,
        entry_facet=entry_facet, hit=hit, **grid,
    )
    if skip_table is not None and (
        skip_table.dtype != torch.float32 or skip_table.dim() != 4
        or len(set(skip_table.shape[:3])) != 1 or skip_table.shape[3] != 8
        or skip_meta.shape != (8,) or skip_meta.dtype != torch.float32
    ):
        raise ValueError("march: unexpected skip grid shapes or dtypes")
    num_rays = origins.shape[0]
    if (
        table.dtype != torch.float32 or table.shape[1] != 64
        or origins.shape != (num_rays, 3) or directions.shape != (num_rays, 3)
        or hull_cells.dtype != torch.int32 or entry_facet.dtype != torch.int32
        or hit.dtype != torch.bool
    ):
        raise ValueError("march: unexpected input shapes or dtypes")
    dev = origins.device
    T = max_steps

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    # K1 writes every byte of these, the padding included.
    cells, t0s, t1s = empty(num_rays, T, dtype=torch.int32), empty(num_rays, T), empty(num_rays, T)
    valid = empty(num_rays, T, dtype=torch.bool)
    stream = MarchStream(vids=empty(num_rays, T + 4, dtype=torch.int32),
                         pos=empty(num_rays, T + 1, 4, dtype=torch.int32),
                         bary=empty(num_rays, T + 1, 4))
    t_entry, num_valid = empty(num_rays), empty(num_rays, dtype=torch.int32)
    hit_out, overflow = empty(num_rays, dtype=torch.bool), empty(num_rays, dtype=torch.bool)
    if num_rays:
        cuda.launch(
            "march", "tetranerf_march", dev,
            *map(cuda.ptr, (table, hull_cells, origins, directions, t_in, t_out,
                            entry_facet, hit)),
            num_rays, T, num_steps, walk_steps, int(bool(use_occupancy)),
            float(depth_cap),
            *((None, None, 0) if skip_table is None else
              (cuda.ptr(skip_table), cuda.ptr(skip_meta), skip_table.shape[0])),
            *map(cuda.ptr, (cells, t0s, t1s, valid, *stream, t_entry, num_valid,
                            hit_out, overflow)),
        )
    return FusedMarch(cells=cells, t1=t1s, t_entry=t_entry, valid=valid,
                      num_valid=num_valid, feats=None, hit=hit_out, overflow=overflow,
                      stream=stream, t0s=t0s)


def march_intervals(
    table, hull_cells, origins, directions, t_in, t_out, entry_facet, hit,
    max_steps: int, num_steps: int, walk_steps: int,
    use_occupancy: bool, depth_cap: float, skip_table=None, skip_meta=None,
) -> FusedMarch:
    """K1 on CUDA tensors, :func:`march_intervals_twin` on CPU tensors."""
    args = (table, hull_cells, origins, directions, t_in, t_out,
            entry_facet, hit, max_steps, num_steps, walk_steps,
            use_occupancy, depth_cap, skip_table, skip_meta)
    if origins.is_cuda:
        return _march_cuda(*args)
    if origins.device.type == "cpu":
        return march_intervals_twin(*args)
    raise ValueError(f"march: unsupported device {origins.device}")


def march(
    mesh,
    origins: torch.Tensor,
    directions: torch.Tensor,
    max_steps: int = 512,
    entry_walk_steps: int = 16,
    use_occupancy: bool = False,
    occ_threshold: float = 1e-3,
    occ_depth_cap=None,
    use_skip: bool = True,
) -> FusedMarch:
    """March rays through ``mesh`` (a :class:`~..geometry.TorchMesh` on the
    rays' device); ``feats`` is left None (see ``fused.march_features``).
    The rays sphere-trace the mesh's skip grid first when ``use_skip`` and
    ``use_occupancy`` are set and the mesh carries one (JAX's condition)."""
    t_in, t_out, entry_facet, hit = hull_intersect(
        mesh.hull_eqs, origins, directions
    )
    # Optical depth at which a ray stops: -log(threshold) unless a
    # calibrated cap is given.
    depth_cap = 0.0
    if use_occupancy:
        depth_cap = (-math.log(occ_threshold) if occ_depth_cap is None
                     else float(occ_depth_cap))
    chunk = min(16, max_steps)
    num_steps = -(-max_steps // chunk) * chunk
    skipping = use_skip and use_occupancy and mesh.has_skip_grid
    return march_intervals(
        mesh.march_table, mesh.hull_cells, origins.contiguous(),
        directions.contiguous(), t_in.contiguous(), t_out.contiguous(),
        entry_facet.contiguous(), hit.contiguous(), max_steps, num_steps,
        entry_walk_steps, use_occupancy, depth_cap,
        *((mesh.skip_table, mesh.skip_meta) if skipping else ()),
    )
