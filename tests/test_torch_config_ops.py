"""The port's config against the JAX package's on a tetrahedra file, and the
public ops ``uniform_sample``, ``biased_warp`` and ``accumulate_along_rays``
against the JAX functions on numpy inputs from a seed."""

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry.io import save_tetrahedra
from tetranerf_torch.models import TetrahedraNerfConfig
from tetranerf_torch.ops import accumulate_along_rays, biased_warp, uniform_sample


@pytest.mark.parametrize("suffix", [".npz", ".th"])
def test_config_counts_come_from_the_tetrahedra_file(tmp_path, suffix):
    """Given only a path, both configs fill the vertex and cell counts from
    the file (written by the port); counts given stay as they are."""
    from tetranerf_tpu.models.config import TetrahedraNerfConfig as JaxConfig

    rng = np.random.default_rng(0)
    path = tmp_path / f"mesh{suffix}"
    save_tetrahedra(path, vertices=rng.normal(size=(11, 3)),
                    cells=rng.integers(0, 11, size=(7, 4)))
    ours, ref = TetrahedraNerfConfig(tetrahedra_path=path), JaxConfig(tetrahedra_path=path)
    assert (ours.num_tetrahedra_vertices, ours.num_tetrahedra_cells) == (11, 7)
    assert (ref.num_tetrahedra_vertices, ref.num_tetrahedra_cells) == (11, 7)
    given = TetrahedraNerfConfig(tetrahedra_path=path, num_tetrahedra_vertices=3,
                                 num_tetrahedra_cells=2)
    assert (given.num_tetrahedra_vertices, given.num_tetrahedra_cells) == (3, 2)


def test_config_refuses_a_missing_tetrahedra_file(tmp_path):
    from tetranerf_tpu.models.config import TetrahedraNerfConfig as JaxConfig

    missing = tmp_path / "missing.th"
    for config in (TetrahedraNerfConfig, JaxConfig):
        with pytest.raises(RuntimeError, match="does not exist"):
            config(tetrahedra_path=missing)


def test_uniform_sample_matches_jax():
    """Edges between each ray's near and far, plain and stratified by the
    same uniforms (JAX draws them from its key: the test passes JAX's draw
    to the port)."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.sampling import uniform_sample as jax_uniform

    rng = np.random.default_rng(1)
    nears = rng.uniform(0.1, 1.0, 6).astype(np.float32)
    fars = nears + rng.uniform(0.5, 3.0, 6).astype(np.float32)
    ref = np.asarray(jax_uniform(None, jnp.asarray(nears), jnp.asarray(fars), 9))
    ours = uniform_sample(torch.from_numpy(nears), torch.from_numpy(fars), 9)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (6, 10), dtype=jnp.float32))
    ref = np.asarray(jax_uniform(key, jnp.asarray(nears), jnp.asarray(fars), 9))
    ours = uniform_sample(torch.from_numpy(nears), torch.from_numpy(fars), 9,
                          u=torch.from_numpy(u))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_biased_warp_matches_jax():
    """Rays with 0, 1 and several valid intervals (gaps between them,
    padding past the count), edges inside and at the ends of the span."""
    import jax.numpy as jnp
    from tetranerf_tpu.ops.sampling import biased_warp as jax_warp

    rng = np.random.default_rng(2)
    num_rays, max_t = 7, 5
    starts = np.cumsum(rng.uniform(0.0, 0.5, (num_rays, max_t)), axis=1) + 1.0
    bounds = np.stack([starts, starts + rng.uniform(0.01, 0.3, starts.shape)], -1)
    num_bounds = np.array([0, 1, 5, 3, 1, 2, 4], np.int32)
    bounds = bounds.astype(np.float32)
    last = bounds[np.arange(num_rays), np.maximum(num_bounds - 1, 0), 1]
    lo = bounds[:, 0, 0]
    samples = np.sort(rng.uniform(lo[:, None], last[:, None], (num_rays, 9)), axis=1)
    samples[:, 0], samples[:, -1] = lo, last
    samples = samples.astype(np.float32)
    ref = np.asarray(jax_warp(jnp.asarray(num_bounds), jnp.asarray(bounds), jnp.asarray(samples)))
    ours = biased_warp(torch.from_numpy(num_bounds), torch.from_numpy(bounds),
                       torch.from_numpy(samples))
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_accumulate_along_rays_matches_jax():
    import jax.numpy as jnp
    from tetranerf_tpu.ops.rendering import accumulate_along_rays as jax_acc

    rng = np.random.default_rng(3)
    w = rng.uniform(size=(5, 8)).astype(np.float32)
    v = rng.normal(size=(5, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(accumulate_along_rays(torch.from_numpy(w)).numpy(),
                               np.asarray(jax_acc(jnp.asarray(w))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        accumulate_along_rays(torch.from_numpy(w), torch.from_numpy(v)).numpy(),
        np.asarray(jax_acc(jnp.asarray(w), jnp.asarray(v))), rtol=1e-6, atol=1e-6)
