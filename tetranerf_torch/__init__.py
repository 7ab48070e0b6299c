"""Tetra-NeRF in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of :mod:`tetranerf_tpu` (the JAX reference, which stays in the
repository unchanged). The package mirrors its layout:

- ``geometry``: Delaunay triangulation and the packed mesh tables
  (:class:`TorchMesh`), built with numpy/scipy on the host.
- ``ops``: hull slab, the march (kernel K1), the stream blend (K2), the
  sample interpolation (K3), samplers, encoding and volume rendering.
  Every kernel has a plain PyTorch twin; a wrapper runs the twin for CPU
  tensors and the kernel for CUDA tensors.
- ``models``: the config dataclass, the MLP building blocks and the
  :class:`TetraNerf` module.
- ``training.checkpoints``: weights to and from the JAX package and the
  reference's state-dict layout.
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
}


def __getattr__(name):
    """Lazy top-level re-exports (keeps ``import tetranerf_torch`` light)."""
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)
