"""Tetra-NeRF in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of :mod:`tetranerf_tpu` (the JAX reference, which stays in the
repository unchanged). The package mirrors its layout:

- ``geometry``: Delaunay triangulation and the packed mesh tables
  (:class:`TorchMesh`), built with numpy/scipy on the host.
- ``ops``: hull slab, the march (kernel K1), the stream blend (K2, and
  its backward K2b), the sample interpolation (K3, and K3b), the row
  scatter-add (K7), the fused field MLPs (K4, K4b) and density MLP (K5,
  K5b) of ``fused_mlps=True``, samplers, encoding and volume rendering.
  Every kernel has a plain PyTorch twin; a wrapper runs the twin for CPU
  tensors and the kernel for CUDA tensors.
- ``models``: the config dataclass, the MLP building blocks and the
  :class:`TetraNerf` module.
- ``training``: the train step (:class:`Trainer`: occupancy upkeep,
  forward, backward through the kernels K2b, K3b and K7, RAdam) and
  weights to and from the JAX package and the reference's state-dict
  layout.
- ``render``: :class:`Renderer`, chunked ray rendering (the serving path).

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "build_mesh": "geometry",
    "triangulate": "geometry",
    "TorchMesh": "geometry",
    "TetraNerf": "models",
    "TetrahedraNerfConfig": "models",
    "tetranerf_preset": "models",
    "Renderer": "render",
    "Trainer": "training.trainer",
    "TrainConfig": "training.trainer",
}


def __getattr__(name):
    """Lazy top-level re-exports (keeps ``import tetranerf_torch`` light)."""
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)
