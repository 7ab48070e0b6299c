"""The port's public names against the JAX package's: every name in a JAX
subpackage's ``__all__`` (and every lazy name of its top level) resolves
in the port's counterpart under the same name, or is one of the kept
differences that ``tetranerf_torch.KEPT_DIFFERENCES`` records with its
reason. Import only."""

import importlib
import inspect
import re

import pytest

import tetranerf_torch

SUBPACKAGES = ["", "training", "utils", "ops", "geometry", "models", "parallel"]


def _jax_names(sub):
    """The public names of ``tetranerf_tpu.<sub>``: its ``__all__``, or for
    the top level the names its lazy ``__getattr__`` resolves."""
    module = importlib.import_module("tetranerf_tpu" + (f".{sub}" if sub else ""))
    if sub:
        return list(module.__all__)
    names = re.findall(r'"(\w+)"', inspect.getsource(module.__getattr__))
    assert names and all(getattr(module, n) is not None for n in names)
    return names


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "top" for s in SUBPACKAGES])
def test_jax_public_names_resolve_in_the_port(sub):
    port = importlib.import_module("tetranerf_torch" + (f".{sub}" if sub else ""))
    kept = tetranerf_torch.KEPT_DIFFERENCES.get(sub, {})
    missing = [n for n in _jax_names(sub) if n not in kept and not hasattr(port, n)]
    assert not missing, f"tetranerf_torch.{sub}: {missing}"
    for name, reason in kept.items():
        assert name in _jax_names(sub) and reason, (sub, name)
        assert not hasattr(port, name), f"{name} is in the port after all"
    # The port's own __all__ names only what it has.
    for name in getattr(port, "__all__", ()):
        assert hasattr(port, name), (sub, name)
