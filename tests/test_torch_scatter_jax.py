"""K7's plain versions against the JAX package, on job lists like a train
step's.

The twin (``scatter_add_rows_batch_twin``, the CPU path) is held to JAX's
``scatter_add_rows`` and to the VJP of ``gather_rows_lowp`` for every row
type, on job lists like a train step's: most rows on id 0 (the padding
slots), mostly zero, ids out of range, empty jobs, F = 64, 32 (model
shards) and 33; and to float8_e8m0fnu's subnormal and NaN rows by hand.
The kernel itself is held to the twin on the card
(``tests/test_torch_backward.py``, ``-m cuda``).

JAX is imported inside tests only.
"""

import numpy as np
import pytest
import torch

from tetranerf_torch.ops import scatter
from tetranerf_torch.ops.stream_dtypes import STREAM_TYPES, round_to, widen

TYPES = list(STREAM_TYPES)
FEATS = (64, 32, 33)
NUM_ROWS = 400
# Job sizes, an empty job among them.
SIZES = (300, 0, 170, 41, 500)
# The twin and JAX sum in f32 in other orders; rows are O(1), a vertex
# gets at most a few hundred.
SUM_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def hot_jobs(rng, sizes, num_rows, feat, name="float32", hot=0.6):
    """Jobs ``(ids i32[n], rows [n, feat])`` in the row type ``name``, as a
    train step gives K7: a share ``hot`` of the ids 0 (padding slots; those
    rows zero but one in a hundred), ids -1 and past the table, the other
    rows one in three zero. float8_e8m0fnu takes the magnitudes (it has no
    sign; its zero rows round to NaN, as the stream's do) and a few values
    that round to its 2^-127."""
    jobs = []
    for n in sizes:
        ids = rng.integers(1, num_rows, n)
        u = rng.random(n)
        ids[u < hot] = 0
        ids[(u >= hot) & (u < hot + 0.02)] = -1
        ids[(u >= hot + 0.02) & (u < hot + 0.04)] = num_rows + 3
        vals = rng.standard_normal((n, feat)).astype(np.float32)
        vals[(ids == 0) & (rng.random(n) > 0.01)] = 0.0
        vals[rng.random(n) < 1 / 3] = 0.0
        if name == "float8_e8m0fnu":
            vals = np.abs(vals)
            vals[rng.random((n, feat)) < 0.05] = 1e-39
        rows = round_to(torch.from_numpy(vals), name)
        jobs.append((torch.from_numpy(ids.astype(np.int32)), rows.contiguous()))
    return jobs


def _close_nan_aware(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), atol=atol, rtol=0)


def test_twin_keeps_subnormals_and_nan():
    """float8_e8m0fnu's 2^-127 adds as a subnormal (two make 2^-126, which
    the card's float atomics would flush to 0), and a NaN row makes its
    vertex's column NaN; the kernel is held to this twin on the card."""
    codes = torch.tensor([[0, 0], [0, 127], [255, 127]], dtype=torch.uint8)
    ids = torch.tensor([1, 1, 2], dtype=torch.int32)
    out = scatter.scatter_add_rows_batch_twin([(ids, codes)], 3, "float8_e8m0fnu")
    assert out[1, 0].item() == 2.0 ** -126 and out[1, 1].item() == 1.0 + 2.0 ** -127
    assert out[2, 0].isnan() and out[2, 1].item() == 1.0
    assert out[0].eq(0).all() and not out[0].signbit().any()


@pytest.mark.parametrize("name", TYPES)
def test_twin_matches_jax_scatter_and_the_lowp_vjp(name):
    """Every row type on the hot-id job list: the twin against JAX's Pallas
    ``scatter_add_rows`` (interpret mode) of the widened rows at F = 64 /
    32 / 33, and against ``jax.vjp`` of ``gather_rows_lowp`` with the rows
    as its cotangent (ids clamped at 0, as the train path passes them; ids
    past the table dropped by both) at one of the three widths, each width
    taken by four types (a JAX compile per type and width)."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import gather_rows_lowp
    from tetranerf_tpu.ops.pallas_scatter import scatter_add_rows as jax_scatter

    for feat in FEATS:
        jobs = hot_jobs(np.random.default_rng(feat), SIZES, NUM_ROWS, feat, name)
        ids = torch.cat([i for i, _ in jobs])
        rows = torch.cat([v for _, v in jobs])
        vals = widen(rows, name).numpy()
        twin = scatter.scatter_add_rows_batch_twin(jobs, NUM_ROWS, name).numpy()
        ref = jax_scatter(jnp.asarray(ids.numpy()), jnp.asarray(vals), NUM_ROWS,
                          window_rows=256, chunk=512, interpret=True)
        _close_nan_aware(twin, ref, SUM_ATOL)
        if feat != FEATS[TYPES.index(name) % len(FEATS)]:
            continue
        clamped = [(i.clamp_min(0), v) for i, v in jobs]
        twin = scatter.scatter_add_rows_batch_twin(clamped, NUM_ROWS, name).numpy()
        # JAX's cotangent in the stream's type: the same codes.
        cot = jnp.asarray(vals).astype(name)
        field = jnp.zeros((NUM_ROWS, feat), jnp.float32)
        _, vjp = jax.vjp(lambda f: gather_rows_lowp(f, jnp.asarray(ids.numpy()), name), field)
        _close_nan_aware(twin, vjp(cot)[0], SUM_ATOL)
