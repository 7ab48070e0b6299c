"""Tetra-NeRF in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of :mod:`tetranerf_tpu` (the JAX reference, which stays in the
repository unchanged). The package mirrors its layout:

- ``geometry``: Delaunay triangulation and the packed mesh tables
  (:class:`TorchMesh`), built with numpy/scipy on the host.
- ``ops``: hull slab, the march (kernel K1), the stream blend (K2, and
  its backward K2b), the sample interpolation (K3, and K3b), the row
  scatter-add (K7), the fused field MLPs (K4, K4b) and density MLP (K5,
  K5b) of ``fused_mlps=True``, the row gather (K8) that cuts the quantile
  buckets out of a march, samplers, encoding and volume rendering.
  Every kernel has a plain PyTorch twin; a wrapper runs the twin for CPU
  tensors and the kernel for CUDA tensors.
- ``models``: the config dataclass, its ``tetra-nerf`` preset
  (``models.tetranerf_preset``), the MLP building blocks and the
  :class:`TetraNerf` module. The top-level ``tetranerf_preset`` and
  ``tetranerf_original_preset`` are the train presets (a ``TrainConfig``),
  as in :mod:`tetranerf_tpu`.
- ``training``: the train step (:class:`Trainer`: bound tune and
  retunes, occupancy upkeep, forward, backward through the kernels K2b,
  K3b and K7, RAdam, eval and rendering at the tuned bounds) and
  weights to and from the JAX package and the reference's state-dict
  layout.
- ``render``: :class:`Renderer`, chunked ray rendering (the serving path);
  ``viewer``: the live orbit viewer (with model shards, served at ``fit``'s
  step boundaries).
- ``torch_adapter``, ``nerfstudio_model``, ``nerfstudio_compat``: the torch
  serving API (:class:`TorchRenderAdapter`, torch tensors in and out), the
  nerfstudio ``Model`` over it and the ``tetra-nerf-torch`` entry points.
- ``scripts``: the console scripts (train is ``training.cli``): render,
  viewer, triangulate and the dataset converters.
- ``parallel``: training over ranks, data shards by feature-field shards.
- ``tracer``: :class:`TetrahedraTracer`, the reference's tracer object
  (``trace_rays``, ``find_visited_cells``, ``find_tetrahedra``,
  ``trace_rays_triangles``) on the march K1 and the point walk K9.

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "build_mesh": "geometry",
    "triangulate": "geometry",
    "TorchMesh": "geometry",
    "TetraNerf": "models",
    "TetrahedraNerfConfig": "models",
    "tetranerf_preset": "training.presets",
    "tetranerf_original_preset": "training.presets",
    "Renderer": "render",
    "Trainer": "training.trainer",
    "TrainConfig": "training.trainer",
    "TetrahedraTracer": "tracer",
    "TorchRenderAdapter": "torch_adapter",
}


KEPT_DIFFERENCES = {
    "": {
        "RayBundle": "the port's models take plain origin and direction tensors",
        "TetrahedraMesh": "the mesh is TorchMesh in the port",
    },
    "models": {
        "RayBundle": "the port's models take plain origin and direction tensors",
    },
    "geometry": {
        "TetrahedraMesh": "the mesh is TorchMesh in the port",
    },
    "training": {
        "TrainState": "the Trainer holds the state",
        "make_train_step": "Trainer.train_step is the step",
    },
    "parallel": dict.fromkeys(
        ("make_mesh", "state_shardings", "batch_sharding", "put_replicated", "replicate",
         "shard_batch", "make_global_batch", "initialize_multihost"),
        "the JAX package's sharding helpers are init_distributed and Group in the port"),
}
"""The public names of the JAX package that the port does not have, by
subpackage ("" for the top level), each with its reason; every other
public name of the JAX package resolves here under the same name."""


def __getattr__(name):
    """Lazy top-level re-exports (keeps ``import tetranerf_torch`` light)."""
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)
