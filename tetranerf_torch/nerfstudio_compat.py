"""nerfstudio method registration of the port (``ns-train tetra-nerf-torch``).

Counterpart of :mod:`tetranerf_tpu.nerfstudio_compat`. The reference
registers its methods through the ``nerfstudio.method_configs`` entry
points (``setup.py:136-141`` -> ``tetranerf/nerfstudio/registration.py``);
the port registers its two presets as ``tetra-nerf-torch`` and
``tetra-nerf-original-torch`` (``pyproject.toml``), so that ``ns-train``
users find them and are sent to the port's own trainer,
``tetranerf-torch-train``: its step runs the port's kernels over whole ray
batches, which nerfstudio's per-chunk torch ``Trainer`` does not drive.

Where nerfstudio imports, a factory returns a ``MethodSpecification`` whose
config carries the port's preset (``tetranerf_config``) for config tooling
to read, and whose ``setup`` raises with the redirect; without nerfstudio it
raises ``ImportError`` with the same message.
"""

from __future__ import annotations

_HELP = (
    "The '{name}' method is provided by tetranerf_torch, which trains "
    "through its own trainer. Run:\n\n"
    "    tetranerf-torch-train --method {name} --data <dir> "
    "[--tetrahedra-path tetra.npz]\n\n"
    "(nerfstudio's torch Trainer drives a model one ray chunk at a time and "
    "does not run this step; see tetranerf_torch/nerfstudio_compat.py.)"
)


def _spec(name: str):
    try:
        from nerfstudio.plugins.types import MethodSpecification  # type: ignore
    except Exception as exc:  # nerfstudio absent (or broken)
        raise ImportError(
            _HELP.format(name=name) + f"\n(nerfstudio import failed: {exc})"
        ) from exc

    from .training.presets import METHODS

    config = METHODS[name]()

    class _Redirect:
        """Stands in for ``TrainerConfig``: its ``setup`` explains how to
        train this method instead of failing deep in the torch stack."""

        method_name = name
        tetranerf_config = config

        def __call__(self, *a, **k):  # pragma: no cover - needs ns-train
            raise RuntimeError(_HELP.format(name=name))

        def setup(self, *a, **k):  # pragma: no cover - needs ns-train
            raise RuntimeError(_HELP.format(name=name))

    return MethodSpecification(config=_Redirect(),  # type: ignore[arg-type]
                               description=_HELP.format(name=name))


def tetranerf():
    """Entry point of the flagship preset (biased sampling)."""
    return _spec("tetra-nerf")


def tetranerf_original():
    """Entry point of the paper's configuration."""
    return _spec("tetra-nerf-original")
