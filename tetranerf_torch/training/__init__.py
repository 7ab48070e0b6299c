"""The train step (:class:`Trainer`), its config and presets, and the
optimizer. The names resolve lazily (as the package's top level does), so
``import tetranerf_torch.training`` stays light."""

_EXPORTS = {
    "Trainer": "trainer",
    "TrainConfig": "trainer",
    "make_optimizer": "optim",
    "tetranerf_preset": "presets",
    "tetranerf_original_preset": "presets",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)
