"""Vertex-field interpolation and index utilities: counterpart of
:mod:`tetranerf_tpu.ops.interpolation` (the reference kernels
``interpolate_values``, ``gather_uint32`` and ``scatter_ema_uint32`` of
``src/tetrahedra_tracer.cu``), as torch ops.

The reference's uint32 ids arrive here as int64 tensors holding their
values (``UINT_MAX`` = 0xFFFFFFFF for an invalid id, as
:func:`~.traversal.trace_rays` returns them) or as int32 tensors holding
their bits (0xFFFFFFFF is -1). An invalid id, ``UINT_MAX`` or negative,
contributes nothing.
"""

from __future__ import annotations

import torch

from .traversal import UINT_MAX


def _ids(indices: torch.Tensor):
    """``(ids int64, valid bool)``: negative ids and ``UINT_MAX`` invalid."""
    ids = indices.to(torch.int64)
    return ids, (ids >= 0) & (ids != UINT_MAX)


def interpolate_values(vertex_indices, barycentric_coordinates, field):
    """A per-vertex field at barycentric sample locations (reference
    ``:195-248``, JAX ``interpolate_values``).

    ``vertex_indices [..., K]`` ids (invalid ones contribute zero);
    ``barycentric_coordinates [..., K-1]`` the weights of vertices
    ``1..K-1`` (vertex 0's is ``1 - sum``), or ``[..., K]`` full weights;
    ``field [F, V]`` (the reference's layout). Returns ``[..., F]``;
    differentiable in ``field`` and the weights."""
    k = vertex_indices.shape[-1]
    bary = barycentric_coordinates
    if bary.shape[-1] == k - 1:
        weights = torch.cat([1.0 - bary.sum(dim=-1, keepdim=True), bary], dim=-1)
    elif bary.shape[-1] == k:
        weights = bary
    else:
        raise ValueError(
            f"barycentric shape {tuple(bary.shape)} does not match vertex indices "
            f"shape {tuple(vertex_indices.shape)}"
        )
    ids, valid = _ids(vertex_indices)
    gathered = field.T[torch.where(valid, ids, 0)]  # [..., K, F]
    weights = torch.where(valid, weights, 0.0)
    return torch.einsum("...k,...kf->...f", weights, gathered)


def _check_1d(name, *tensors):
    if any(t.dim() != 1 for t in tensors):
        raise ValueError(f"{name} supports only 1-D inputs")


def gather_uint32(indices, values):
    """``out[i] = values[indices[i]]``, 0 where the id is invalid or out of
    bounds (reference ``:30-52``)."""
    _check_1d("gather_uint32", indices, values)
    ids, valid = _ids(indices)
    valid &= ids < values.shape[0]
    return torch.where(valid, values[torch.where(valid, ids, 0)], 0)


def _last_writes(ids, valid, size):
    """Positions ``i`` of the valid ids that write, one per id: the last
    with that id (the order in which XLA's scatter on the CPU keeps them)."""
    pos = torch.arange(ids.shape[0], device=ids.device)
    last = torch.full((size,), -1, dtype=torch.int64, device=ids.device)
    last.scatter_reduce_(0, ids[valid], pos[valid], "amax")
    return last[last >= 0]


def scatter_ema_uint32(target, indices, values, decay: float):
    """``target[i_k] = decay * target[i_k] + (1 - decay) * values[k]``, as a
    new tensor (the reference's in-place ``scatter_ema_uint32_``,
    ``:55-113``). Invalid and out-of-bounds ids are dropped. With duplicate
    ids one update is kept, each read from the old ``target``: the last,
    where the reference's CAS loop keeps them in no fixed order."""
    _check_1d("scatter_ema_uint32", target, indices, values)
    ids, valid = _ids(indices)
    valid &= ids < target.shape[0]
    read = torch.where(valid, ids, 0)
    updated = decay * target[read] + (1.0 - decay) * values
    writes = _last_writes(ids, valid, target.shape[0])
    out = target.clone()
    out[ids[writes]] = updated[writes].to(out.dtype)
    return out
