"""The port's tracer API (``tetranerf_torch.tracer`` and its ops:
``ops/traversal.py``, ``matching.py``, ``parity.py``, ``interpolation.py``,
``barycentric.py``) against the JAX functions on the CPU, on the same numpy
inputs, as ``tests/test_traversal.py``, ``test_parity.py`` and
``test_interpolation.py`` exercise the JAX ones.

The port's traversal is the neighbour march (K1's twin here) plus JAX's
near-plane shift; JAX's ``traversal.march`` and ``fused.march_features``
(which K1 ports) give the same cells and bit-equal distances once the
intervals entered before the near plane are dropped, which the scenes below
check for rays from outside and from inside the hull. Cells and ids are
held exactly, distances to 1e-5 (``test_golden_trace.py``'s), barycentrics
to 1e-4, and the differentiable ops' values and gradients to 1e-5 of
``jax.grad``.

The march's distances differ from JAX's by an ulp here and there (K1's
twin and XLA round a few steps differently). A barycentric is a plane
``n . p + d`` at that distance, so in a sliver cell (``|n|`` in the
thousands on the sphere scene) an ulp of distance moves it by up to
``|n| |dt|``, ~5e-4: such entries are held to ``1e-4 + 2 |n| |dt|`` with
their own ``dt``, and the port's barycentrics are JAX's plane evaluation
at the port's distances, bit for bit. The ``cuda`` cases run the facade on
the card (K1 and K9) against the facade on the CPU."""

from pathlib import Path

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import TorchMesh
from tetranerf_torch.ops.barycentric import add_barycentrics_grad, barycentric_coordinates
from tetranerf_torch.ops.interpolation import (
    gather_uint32,
    interpolate_values,
    scatter_ema_uint32,
)
from tetranerf_torch.ops.matching import find_visited_cells, match_samples
from tetranerf_torch.ops.parity import find_tetrahedra, trace_rays_triangles, update_occupancy
from tetranerf_torch.ops.traversal import UINT_MAX, march, trace_rays
from tetranerf_torch.tracer import TetrahedraTracer
from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays

ASSET = Path(__file__).parent / "assets" / "golden_march.npz"
DIST_ATOL = 1e-5
BARY_ATOL = 1e-4
GRAD_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inside_rays(rng, num, scale=0.3):
    o = rng.uniform(-scale, scale, (num, 3))
    d = rng.normal(size=(num, 3))
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _scene_inputs():
    """Per scene: points, rays (origins, directions) and the march bound.
    ``golden``: the golden trace's asset; ``sphere``: a 1500-point sphere
    with rays from outside and from inside the hull (the near-plane
    shift)."""
    with np.load(ASSET) as g:
        out = {"golden": (g["points"], g["origins"], g["directions"], 96)}
    points, _ = make_sphere_scene(1500, seed=3)
    rng = np.random.default_rng(5)
    o1, d1 = sample_sphere_rays(rng, 48)
    o2, d2 = _inside_rays(rng, 16)
    out["sphere"] = (points, np.concatenate([o1, o2]), np.concatenate([d1, d2]), 80)
    return {k: (p, o.astype(np.float32), d.astype(np.float32), t)
            for k, (p, o, d, t) in out.items()}


@pytest.fixture(scope="module")
def scenes():
    """Per scene of :func:`_scene_inputs`: the JAX mesh, the port's mesh
    from its tables, the rays and the march bound."""
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh

    out = {}
    for k, (points, o, d, t) in _scene_inputs().items():
        jmesh = jax_build_mesh(points)
        out[k] = (jmesh, TorchMesh.from_tables(jmesh, device="cpu"), o, d, t)
    return out


@pytest.fixture(scope="module")
def jax_refs(scenes):
    """The JAX functions' outputs, once per scene: ``march``, ``trace_rays``
    and ``trace_rays_triangles`` marching the scene's bound (the triangles'
    ``max_hits`` one more, so that all three share JAX's compiled march)
    and ``find_tetrahedra`` of :func:`_query_points`."""
    from tetranerf_tpu.ops import find_tetrahedra as jax_find
    from tetranerf_tpu.ops import march as jax_march
    from tetranerf_tpu.ops import trace_rays as jax_trace_rays
    from tetranerf_tpu.ops import trace_rays_triangles as jax_triangles

    cache = {}

    def get(name):
        if name not in cache:
            jmesh, _, o, d, steps = scenes[name]
            points = _query_points(jmesh, np.random.default_rng(7))
            cache[name] = dict(march=jax_march(jmesh, o, d, max_steps=steps),
                               trace=jax_trace_rays(jmesh, o, d, steps),
                               triangles=jax_triangles(jmesh, o, d, steps + 1),
                               points=points, find=jax_find(jmesh, points))
        return cache[name]

    return get


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ids_equal(ours, theirs):
    """Ids: the port's int64 values against JAX's uint32 or int32."""
    np.testing.assert_array_equal(_np(ours).astype(np.int64), _np(theirs).astype(np.int64))


def _tensors(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _check_barycentrics(ours, theirs, jmesh, cells, dist, ref_dist):
    """Barycentric weights ``[R, S, ..., W]`` of intervals in ``cells
    [R, S]`` (JAX ids, padding invalid) at distances ``dist [R, S, ...]``
    where JAX's are ``ref_dist``: to 1e-4 plus twice the cell's largest
    plane normal times the distances' difference (none where they are
    equal; padding is ``inf`` in both)."""
    ours, theirs = _np(ours), _np(theirs)
    finite = np.isfinite(dist) & np.isfinite(ref_dist)
    dt = np.abs(np.where(finite, dist, 0.0) - np.where(finite, ref_dist, 0.0))
    cells = _np(cells).astype(np.int64)
    valid = (cells >= 0) & (cells < len(jmesh.cells))
    norm = np.linalg.norm(np.asarray(jmesh.planes)[np.where(valid, cells, 0)][..., :3],
                          axis=-1).max(-1)
    bound = BARY_ATOL + 2.0 * norm.reshape(norm.shape + (1,) * (dt.ndim - norm.ndim)) * dt
    err = np.abs(ours - theirs).max(-1)
    assert (err <= bound).all(), (err - bound).max()
    assert (err[dt == 0] <= BARY_ATOL).all()


@pytest.mark.parametrize("name", ["golden", "sphere"])
def test_march_is_jax_traversal_march(scenes, jax_refs, name):
    """The facade's march (K1's twin, then the near-plane shift) against
    JAX ``traversal.march``, and JAX's two marches against each other once
    ``march_features``' intervals before the near plane are dropped."""
    from tetranerf_tpu.ops import march_features as jax_march_features

    jmesh, mesh, o, d, steps = scenes[name]
    ref = jax_refs(name)["march"]
    res = march(mesh, *_tensors(o, d), max_steps=steps)
    num = _np(ref.num_cells)
    np.testing.assert_array_equal(_np(res.num_cells), num)
    _ids_equal(res.cells, ref.cells)
    for ours, theirs in ((res.t0, ref.t0), (res.t1, ref.t1)):
        np.testing.assert_allclose(_np(ours), _np(theirs), atol=DIST_ATOL, rtol=0)
    if name == "golden":
        return  # tests/test_golden_trace.py holds both JAX marches to the asset
    fused = jax_march_features(jmesh, None, o, d, max_steps=steps)
    valid, t0 = _np(fused.valid), _np(fused.t0)
    drop = (valid & (t0 < 0.0)).sum(axis=1)
    assert (drop > 0).any()
    for r, n in enumerate(num):
        cells = _np(fused.cells)[r, drop[r]:drop[r] + n]
        np.testing.assert_array_equal(cells, _np(ref.cells)[r, :n])
        np.testing.assert_array_equal(t0[r, drop[r]:drop[r] + n], _np(ref.t0)[r, :n])


@pytest.mark.parametrize("name", ["golden", "sphere"])
def test_trace_rays_matches_jax(scenes, jax_refs, name):
    jmesh, mesh, o, d, steps = scenes[name]
    ref = jax_refs(name)["trace"]
    out = trace_rays(mesh, *_tensors(o, d), steps)
    np.testing.assert_array_equal(_np(out["num_visited_cells"]), _np(ref["num_visited_cells"]))
    for k in ("visited_cells", "vertex_indices"):
        assert out[k].dtype == torch.int64
        _ids_equal(out[k], ref[k])
    assert int(out["visited_cells"][-1, -1]) == UINT_MAX
    dist = _np(out["hit_distances"])
    np.testing.assert_allclose(dist, _np(ref["hit_distances"]), atol=DIST_ATOL, rtol=0)
    _check_barycentrics(out["barycentric_coordinates"], ref["barycentric_coordinates"], jmesh,
                        ref["visited_cells"], dist, _np(ref["hit_distances"]))
    # At the port's own distances the port's barycentrics are JAX's planes'.
    from tetranerf_tpu.ops.traversal import _eval_planes

    valid = _np(out["visited_cells"]) != UINT_MAX
    planes = np.asarray(jmesh.planes)[np.where(valid, _np(out["visited_cells"]), 0)]
    for end in range(2):
        p = o[:, None, :] + dist[..., end, None] * d[:, None, :]
        expect = np.where(valid[..., None], np.asarray(_eval_planes(planes, p))[..., 1:], 0.0)
        np.testing.assert_array_equal(_np(out["barycentric_coordinates"])[..., end, :], expect)


@pytest.mark.parametrize("name", ["golden", "sphere"])
def test_trace_rays_triangles_matches_jax(scenes, jax_refs, name):
    jmesh, mesh, o, d, steps = scenes[name]
    ref = jax_refs(name)["triangles"]
    out = trace_rays_triangles(mesh, *_tensors(o, d), steps + 1)
    np.testing.assert_array_equal(_np(out["num_hits"]), _np(ref["num_hits"]))
    assert int(out["num_hits"].max()) > 2
    _ids_equal(out["vertex_indices"], ref["vertex_indices"])
    dist = _np(out["hit_distances"])
    np.testing.assert_allclose(dist, _np(ref["hit_distances"]), atol=DIST_ATOL, rtol=0)
    # Hit k + 1 leaves interval k, hit 0 enters interval 0.
    cells = _np(march(mesh, *_tensors(o, d), max_steps=steps).cells)
    cells = np.concatenate([cells[:, :1], cells], axis=1)
    _check_barycentrics(out["barycentric_coordinates"], ref["barycentric_coordinates"], jmesh,
                        cells, dist, _np(ref["hit_distances"]))


def _query_points(mesh, rng, num=200):
    """Points mixed in random cells (inside), plus points spread over the
    vertices' bounding box grown by a fifth (some outside the hull)."""
    verts, cells = np.asarray(mesh.vertices), np.asarray(mesh.cells)
    pick = rng.integers(0, len(cells), num // 2)
    w = rng.dirichlet(np.ones(4) * 4.0, size=num // 2)
    mixed = np.einsum("sk,skd->sd", w, verts[cells[pick]])
    lo, hi = verts.min(0), verts.max(0)
    pad = 0.2 * (hi - lo)
    spread = rng.uniform(lo - pad, hi + pad, (num - num // 2, 3))
    return np.concatenate([mixed, spread]).astype(np.float32)


@pytest.mark.parametrize("name", ["golden", "sphere"])
def test_find_tetrahedra_matches_jax(scenes, jax_refs, name):
    jmesh, mesh, *_ = scenes[name]
    points, ref = jax_refs(name)["points"], jax_refs(name)["find"]
    (pts,) = _tensors(points)
    out = find_tetrahedra(mesh, pts)
    np.testing.assert_array_equal(_np(out["tetrahedra"]), _np(ref["tetrahedra"]))
    np.testing.assert_array_equal(_np(out["valid_mask"]), _np(ref["valid_mask"]))
    valid = _np(out["valid_mask"])
    assert valid[:100].all() and not valid.all()
    _ids_equal(out["vertex_indices"], ref["vertex_indices"])
    np.testing.assert_allclose(_np(out["barycentric_coordinates"]),
                               _np(ref["barycentric_coordinates"]), atol=BARY_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["golden", "sphere"])
def test_find_visited_cells_and_match_samples_match_jax(scenes, jax_refs, name):
    """Sample matching on JAX's tracer outputs and on the march: masks and
    ids exactly JAX's, barycentrics to 1e-4."""
    from tetranerf_tpu.ops import match_samples as jax_match
    from tetranerf_tpu.ops.matching import find_visited_cells as jax_visited

    jmesh, mesh, o, d, steps = scenes[name]
    rng = np.random.default_rng(11)
    traced = jax_refs(name)["trace"]
    hd = _np(traced["hit_distances"])
    span = np.maximum(hd[:, :, 1].max(1), 1e-3)
    dist = np.sort(rng.uniform(-0.1, 1.1, (len(o), 24)) * span[:, None], axis=1)
    dist = dist.astype(np.float32)
    ref = jax_visited(*(traced[k] for k in ("num_visited_cells", "visited_cells",
                                              "barycentric_coordinates", "hit_distances",
                                              "vertex_indices")), dist)
    # JAX's traced outputs as the port takes them (uint32 ids as int64).
    out = find_visited_cells(*(torch.from_numpy(_np(traced[k]).astype(
        np.int64 if _np(traced[k]).dtype.kind in "iu" else np.float32)) for k in (
        "num_visited_cells", "visited_cells", "barycentric_coordinates", "hit_distances",
        "vertex_indices")), *_tensors(dist))
    mask = _np(out["mask"])
    np.testing.assert_array_equal(mask, _np(ref["mask"]))
    assert mask.any() and not mask.all()
    for k in ("cell_indices", "vertex_indices"):
        _ids_equal(out[k], ref[k])
    np.testing.assert_allclose(_np(out["barycentric_coordinates"]),
                               _np(ref["barycentric_coordinates"]), atol=BARY_ATOL, rtol=0)

    ref = jax_match(jmesh, jax_refs(name)["march"], dist, o, d)
    out = match_samples(mesh, march(mesh, *_tensors(o, d), max_steps=steps),
                        *_tensors(dist, o, d))
    np.testing.assert_array_equal(_np(out["mask"]), _np(ref["mask"]))
    for k in ("cell_indices", "vertex_indices"):
        _ids_equal(out[k], ref[k])
    # At the samples' own distances: the planes evaluated at the same points.
    np.testing.assert_allclose(_np(out["barycentric"]), _np(ref["barycentric"]),
                               atol=BARY_ATOL, rtol=0)


@pytest.mark.parametrize("k, full", [(2, False), (3, False), (4, False), (6, False),
                                     (4, True)])
def test_interpolate_values_and_gradients_match_jax(k, full):
    """Values and the gradients to the field and the weights against
    ``jax.grad``; one id in eight invalid (uint32 ``UINT_MAX`` in JAX,
    int64 ``UINT_MAX`` and int32 -1 here)."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops import interpolate_values as jax_interp

    rng = np.random.default_rng(k)
    num_vertices, num_feat, n = 50, 8, 40
    field = rng.normal(size=(num_feat, num_vertices)).astype(np.float32)
    ids = rng.integers(0, num_vertices, size=(n, k)).astype(np.int64)
    ids[rng.random((n, k)) < 0.125] = UINT_MAX
    bary = (rng.normal(size=(n, k if full else k - 1)) * 0.3).astype(np.float32)
    g = rng.normal(size=(n, num_feat)).astype(np.float32)

    def loss(f, b):
        return jnp.sum(jax_interp(jnp.asarray(ids.astype(np.uint32)), b, f) * g)

    ref = np.asarray(jax_interp(jnp.asarray(ids.astype(np.uint32)), bary, field))
    ref_gf, ref_gb = jax.grad(loss, argnums=(0, 1))(field, bary)
    for id_tensor in (torch.from_numpy(ids), torch.from_numpy(ids.astype(np.uint32).view(np.int32))):
        f_t, b_t = (torch.from_numpy(x).requires_grad_() for x in (field, bary))
        out = interpolate_values(id_tensor, b_t, f_t)
        np.testing.assert_allclose(_np(out), ref, atol=GRAD_ATOL, rtol=0)
        (out * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(_np(f_t.grad), np.asarray(ref_gf), atol=GRAD_ATOL, rtol=0)
        np.testing.assert_allclose(_np(b_t.grad), np.asarray(ref_gb), atol=GRAD_ATOL, rtol=0)
    with pytest.raises(ValueError):
        interpolate_values(torch.from_numpy(ids), torch.zeros(n, k + 1), torch.from_numpy(field))


def test_barycentrics_and_their_gradients_match_jax():
    """``barycentric_coordinates`` and the gradients of a loss of it to the
    vertices and the points against ``jax.grad``; ``add_barycentrics_grad``
    is the identity with those gradients."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops import add_barycentrics_grad as jax_add
    from tetranerf_tpu.ops import barycentric_coordinates as jax_bary

    rng = np.random.default_rng(2)
    verts = rng.normal(size=(16, 4, 3)).astype(np.float32)
    w = rng.dirichlet(np.ones(4), size=16).astype(np.float32)
    points = np.einsum("sk,skd->sd", w, verts).astype(np.float32)
    g = rng.normal(size=(16, 3)).astype(np.float32)

    def loss(fn, v, p):
        return jnp.sum(fn(v, p) ** 2 * g)

    ref = np.array(jax_bary(verts, points))
    np.testing.assert_allclose(ref, w[:, 1:], atol=1e-4)
    ref_gv, ref_gp = jax.grad(lambda v, p: loss(jax_bary, v, p), argnums=(0, 1))(verts, points)
    ref_add = jax.grad(lambda v, p: loss(lambda v_, p_: jax_add(jnp.asarray(ref), v_, p_), v, p),
                       argnums=(0, 1))(verts, points)
    for fn in (barycentric_coordinates,
               lambda v, p: add_barycentrics_grad(torch.from_numpy(ref.copy()), v, p)):
        v_t, p_t = (torch.from_numpy(x).requires_grad_() for x in (verts, points))
        out = fn(v_t, p_t)
        np.testing.assert_allclose(_np(out), ref, atol=GRAD_ATOL, rtol=0)
        (out ** 2 * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(_np(v_t.grad), np.asarray(ref_gv), atol=GRAD_ATOL, rtol=0)
        np.testing.assert_allclose(_np(p_t.grad), np.asarray(ref_gp), atol=GRAD_ATOL, rtol=0)
    for ours, theirs in zip((ref_gv, ref_gp), ref_add):
        np.testing.assert_allclose(np.asarray(theirs), np.asarray(ours), atol=GRAD_ATOL)


def test_uint32_gather_scatter_and_occupancy_match_jax():
    """``gather_uint32``, ``scatter_ema_uint32`` and ``update_occupancy``
    against JAX on ids with duplicates, out-of-bounds and invalid entries:
    JAX's tests' cases, then random ids (each duplicated target keeps one
    update, the same as JAX's on the CPU)."""
    import jax.numpy as jnp
    from tetranerf_tpu.ops import gather_uint32 as jax_gather
    from tetranerf_tpu.ops import scatter_ema_uint32 as jax_scatter
    from tetranerf_tpu.ops import update_occupancy as jax_update

    vals = np.arange(10, dtype=np.float32)
    idx = np.array([3, 7, 100, 0, UINT_MAX], dtype=np.int64)
    np.testing.assert_array_equal(_np(gather_uint32(*_tensors(idx, vals))),
                                  [3.0, 7.0, 0.0, 0.0, 0.0])
    with pytest.raises(ValueError):
        gather_uint32(torch.zeros(2, 2, dtype=torch.int64), torch.from_numpy(vals))
    target = np.ones(5, np.float32)
    out = scatter_ema_uint32(*_tensors(target, np.array([0, 2, 9], np.int64),
                                       np.array([3.0, 5.0, 7.0], np.float32)), decay=0.5)
    np.testing.assert_allclose(_np(out), [2.0, 1.0, 3.0, 1.0, 1.0])
    out = update_occupancy(torch.zeros(6), torch.tensor([[0, 2], [4, -1]], dtype=torch.int32),
                           torch.tensor([[1.0, 1.0], [0.5, 9.9]]), decay=0.9)
    np.testing.assert_allclose(_np(out), [0.1, 0.0, 0.1, 0.0, 0.05, 0.0], atol=1e-6)

    rng = np.random.default_rng(4)
    ids = rng.integers(0, 40, 64).astype(np.int64)  # duplicates and ids past 32
    ids[::9] = UINT_MAX
    ids_u32 = jnp.asarray(ids.astype(np.uint32))
    values = rng.random(64).astype(np.float32)
    table = rng.random(32).astype(np.float32)
    assert len(np.unique(ids)) < len(ids)
    for id_tensor in _tensors(ids, ids.astype(np.uint32).view(np.int32)):
        np.testing.assert_array_equal(_np(gather_uint32(id_tensor, torch.from_numpy(table))),
                                      np.asarray(jax_gather(ids_u32, table)))
        np.testing.assert_array_equal(
            _np(scatter_ema_uint32(torch.from_numpy(table), id_tensor,
                                   torch.from_numpy(values), 0.75)),
            np.asarray(jax_scatter(table, ids_u32, values, 0.75)))
    cells = np.where(ids == UINT_MAX, -1, ids).astype(np.int32).reshape(8, 8)
    np.testing.assert_array_equal(
        _np(update_occupancy(*_tensors(table, cells, values.reshape(8, 8)), decay=0.9)),
        np.asarray(jax_update(table, cells, values.reshape(8, 8), decay=0.9)))


def test_tracer_facade_matches_jax(scenes, jax_refs):
    """The object API on the CPU (as ``tests/test_parity.py``'s facade test
    drives JAX's ``TetrahedraTracer``) against the JAX functions the JAX
    facade calls, on the same vertices, cells and inputs; the unloaded
    tracer's error; the default device is the card."""
    from tetranerf_tpu.ops.matching import find_visited_cells as jax_visited

    jmesh, _, o, d, steps = scenes["sphere"]
    refs = jax_refs("sphere")
    tracer = TetrahedraTracer(device="cpu")
    with pytest.raises(RuntimeError, match="load_tetrahedra"):
        tracer.trace_rays(o[:1], d[:1])
    tracer.load_tetrahedra(np.asarray(jmesh.vertices), np.asarray(jmesh.cells))
    out = tracer.trace_rays(o, d, steps)
    _ids_equal(out["visited_cells"], refs["trace"]["visited_cells"])
    keys = ("num_visited_cells", "visited_cells", "barycentric_coordinates", "hit_distances",
            "vertex_indices")
    dist = np.asarray(refs["trace"]["hit_distances"]).mean(-1)[:, :3]
    # JAX's outputs as they come (uint32 ids): the tracer takes any numbers.
    matched = tracer.find_visited_cells(*(np.array(refs["trace"][k]) for k in keys), dist)
    ref_matched = jax_visited(*(refs["trace"][k] for k in keys), dist)
    np.testing.assert_array_equal(_np(matched["mask"]), _np(ref_matched["mask"]))
    assert _np(matched["mask"]).all()
    _ids_equal(matched["cell_indices"], ref_matched["cell_indices"])
    np.testing.assert_array_equal(_np(tracer.find_tetrahedra(refs["points"])["tetrahedra"]),
                                  _np(refs["find"]["tetrahedra"]))
    tri = tracer.trace_rays_triangles(o, d, steps + 1)
    _ids_equal(tri["vertex_indices"], refs["triangles"]["vertex_indices"])
    assert TetrahedraTracer().device == torch.device("cuda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the facade's traversal runs K1 and K9 on the card")
    return torch.device("cuda")


def _same(a, b, atol):
    for k in b:
        x, y = _np(a[k]), _np(b[k])
        if np.issubdtype(y.dtype, np.floating):
            np.testing.assert_allclose(x, y, atol=atol, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["golden", "sphere"])
def test_facade_on_the_card_matches_the_cpu(name, cuda_device):
    """The tracer on the card (K1 for ``trace_rays`` and
    ``trace_rays_triangles``, K9 for ``find_tetrahedra``, each launched)
    against the tracer on the CPU: ids exact, distances to 1e-5,
    barycentrics to 1e-4 (at K1's distances, to the bound of the module's
    docstring)."""
    from tetranerf_torch.geometry import triangulate
    from tetranerf_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    verts, o, d, steps = _scene_inputs()[name]
    cpu, card = TetrahedraTracer("cpu"), TetrahedraTracer(cuda_device)
    cells = triangulate(verts)
    for tracer in (cpu, card):
        tracer.load_tetrahedra(verts, cells)
    points = _query_points(cpu.mesh, np.random.default_rng(7))
    before = dict(cuda.launch_counts)
    outs = [(t.trace_rays(o, d, steps), t.trace_rays_triangles(o, d, steps + 1),
             t.find_tetrahedra(points)) for t in (card, cpu)]
    torch.cuda.synchronize()
    assert cuda.launch_counts["march"] == before["march"] + 2
    assert cuda.launch_counts["locate"] == before["locate"] + 1
    visited = _np(outs[1][0]["visited_cells"])
    bary = "barycentric_coordinates"
    for ours, ref, cells_of in zip(*outs, (visited, np.concatenate(
            [visited[:, :1], visited], axis=1), None)):
        _same({k: v for k, v in ours.items() if k != bary},
              {k: v for k, v in ref.items() if k != bary}, DIST_ATOL)
        if cells_of is None:  # the same points: the same planes at them
            _same({bary: ours[bary]}, {bary: ref[bary]}, BARY_ATOL)
        else:  # at K1's distances against its twin's
            _check_barycentrics(ours[bary], ref[bary], cpu.mesh, cells_of,
                                _np(ours["hit_distances"]), _np(ref["hit_distances"]))
    traced = outs[0][0]
    dist = _np(traced["hit_distances"]).mean(-1)[:, :3]
    keys = ("num_visited_cells", "visited_cells", "barycentric_coordinates", "hit_distances",
            "vertex_indices")
    _same(card.find_visited_cells(*(traced[k] for k in keys), dist),
          cpu.find_visited_cells(*(traced[k].cpu() for k in keys), dist), BARY_ATOL)
