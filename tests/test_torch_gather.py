"""The row gather K8 (``ops/gather.py``), one table and a batch: the plain
twins against the JAX Pallas kernel (interpret mode), the wrappers'
dispatch, and on the card the kernel against its twin.

JAX is imported inside tests only, so the CUDA cases also run where JAX is
absent: ``python -m pytest --noconftest -m cuda tests/test_torch_gather.py``.
"""

import numpy as np
import pytest
import torch

from tetranerf_torch.ops import cuda
from tetranerf_torch.ops.gather import (
    row_gather,
    row_gather_batch,
    row_gather_batch_twin,
    row_gather_twin,
)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_twin_matches_pallas_gather_bit_for_bit(dtype):
    """The shapes of ``tests/test_pallas.py``: a [500, 128] table, 64 rows.
    A gather copies: the two must agree bit for bit."""
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_gather import pallas_gather_rows

    rng = np.random.default_rng(42)
    tab = rng.normal(size=(500, 128)).astype(np.float32)
    if dtype is np.int32:  # ids bit-cast into float columns are denormals
        tab = rng.integers(0, 1 << 20, size=(500, 128)).astype(np.int32).view(np.float32)
    idx = rng.integers(0, 500, size=64).astype(np.int32)
    ref = np.asarray(pallas_gather_rows(jnp.asarray(idx), jnp.asarray(tab),
                                        block_rows=32, num_buffers=4, interpret=True))
    out = row_gather(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    assert out.shape == (64, 128) and out.dtype == np.float32
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bool, torch.uint8])
def test_twin_takes_a_column_prefix_of_a_strided_table(dtype):
    """Rows of any stride, a prefix of the columns, 4-byte and 1-byte
    types, indices repeated and in any order; the output is contiguous."""
    gen = torch.Generator().manual_seed(0)
    wide = torch.randint(0, 200, (40, 37), generator=gen).to(dtype)
    table = wide[:, :29]  # row stride 37, 29 columns
    idx = torch.tensor([3, 3, 0, 39, 17, 5], dtype=torch.int32)
    out = row_gather(table, idx, 11)
    assert out.is_contiguous() and out.dtype == dtype and out.shape == (6, 11)
    for i, r in enumerate(idx.tolist()):
        assert torch.equal(out[i], wide[r, :11])
    assert torch.equal(row_gather(table, idx), table[idx.long()])
    assert row_gather(table, idx[:0], 11).shape == (0, 11)


def test_wrapper_runs_the_twin_on_cpu_and_refuses_other_devices():
    before = dict(cuda.launch_counts)
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([2, 0], dtype=torch.int32)
    assert torch.equal(row_gather(table, idx, 2), row_gather_twin(table, idx, 2))
    assert cuda.launch_counts == before
    with pytest.raises(ValueError, match="unsupported device"):
        row_gather(table.to("meta"), idx.to("meta"), 2)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the row-gather kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, cols, width", [
    (torch.float32, 128, 128),  # 16-byte rows throughout
    (torch.float32, 516, 388),  # a stream prefix: t + 4 ids at t = 384
    (torch.int32, 37, 13),      # rows off the 16-byte grid: 4-byte path + tail
    (torch.bool, 384, 128),     # the 1-byte valid mask at a bucket bound
    (torch.uint8, 45, 7),       # 1-byte rows off every grid: bytes only
])
def test_kernel_matches_twin(cuda_device, dtype, cols, width):
    """A copy: equal bit for bit."""
    gen = torch.Generator().manual_seed(cols)
    wide = torch.randint(0, 255, (1000, cols + 3), generator=gen).to(dtype)
    table = wide[:, :cols].to(cuda_device)  # a strided prefix view
    idx = torch.randint(0, 1000, (4099,), generator=gen, dtype=torch.int32).to(cuda_device)
    before = cuda.launch_counts["row_gather"]
    out = row_gather(table, idx, width)
    torch.cuda.synchronize()
    assert cuda.launch_counts["row_gather"] == before + 1
    assert out.is_contiguous()
    assert torch.equal(out, row_gather_twin(table, idx, width))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    table = torch.zeros((8, 4), device=cuda_device)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    for bad in (table.double(), table.t(), table[None]):
        with pytest.raises(ValueError):
            row_gather(bad, idx, 2)
    with pytest.raises(ValueError):
        row_gather(table, idx.long(), 2)
    with pytest.raises(ValueError):
        row_gather(table, idx, 5)


# ------------------------------------------------------------ the batch


def _batch_jobs(np_dtype, rng):
    """Jobs on [N, 128] tables of one dtype: full rows, a misaligned
    prefix, 1-column jobs, width 0 and an empty index vector."""
    def table(rows):
        if np_dtype is np.float32:
            return rng.normal(size=(rows, 128)).astype(np.float32)
        if np_dtype is np.bool_:
            return rng.random((rows, 128)) < 0.5
        return rng.integers(0, 256, size=(rows, 128)).astype(np_dtype)

    tables = [table(300), table(77)]
    spec = [(0, 64, 128), (1, 32, 37), (0, 96, 1), (1, 32, 1), (0, 32, 0), (1, 0, 5)]
    return [(tables[t], rng.integers(0, tables[t].shape[0], size=m).astype(np.int32), w)
            for t, m, w in spec]


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_, np.uint8])
def test_batch_twin_matches_pallas_gather_job_by_job(dtype):
    """Each job of a batch against the JAX Pallas gather of its full rows
    (interpret mode, as ``test_twin_matches_pallas_gather_bit_for_bit``),
    cut to the job's width: equal bit for bit, in job order."""
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_gather import pallas_gather_rows

    jobs = _batch_jobs(dtype, np.random.default_rng(7))
    outs = row_gather_batch([(torch.from_numpy(t), torch.from_numpy(i), w)
                             for t, i, w in jobs])
    assert len(outs) == len(jobs)
    for (tab, idx, w), out in zip(jobs, outs):
        if len(idx):
            ref = np.asarray(pallas_gather_rows(jnp.asarray(idx), jnp.asarray(tab),
                                                block_rows=32, num_buffers=4,
                                                interpret=True))[:, :w]
        else:
            ref = tab[:0, :w]
        assert out.shape == (len(idx), w) and out.is_contiguous()
        assert out.numpy().dtype == tab.dtype
        np.testing.assert_array_equal(out.numpy(), ref)


def test_batch_wrapper_runs_the_twin_on_cpu_and_refuses_other_devices():
    before = dict(cuda.launch_counts)
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([2, 0], dtype=torch.int32)
    jobs = [(table, idx, 2), (table[:, :1], idx[:1], 1)]
    for out, ref in zip(row_gather_batch(jobs), row_gather_batch_twin(jobs)):
        assert torch.equal(out, ref)
    assert row_gather_batch([]) == []
    assert cuda.launch_counts == before
    with pytest.raises(ValueError, match="unsupported device"):
        row_gather_batch([(table.to("meta"), idx.to("meta"), 2)])


@pytest.mark.cuda
def test_batch_kernel_matches_twin(cuda_device):
    """One launch: rows off the 16-byte grid (1-byte rows of odd widths,
    4-byte rows of 13 columns), an empty bucket, width 0, 1-column jobs,
    1-byte and 4-byte jobs mixed; bit for bit against the twin and against
    the single-table K8, job by job."""
    gen = torch.Generator().manual_seed(3)
    wide = torch.randint(0, 255, (1000, 519), generator=gen, dtype=torch.int32)
    tables = [wide[:, :516].float().to(cuda_device),           # strided f32
              wide[:, 3:40].to(cuda_device),                   # misaligned i32
              (wide[:, :233] > 127).to(cuda_device),           # bool rows of 233
              wide[:, 5:50].to(torch.uint8).to(cuda_device),   # misaligned u8
              wide[:, 0].contiguous().to(cuda_device)[:, None]]  # a per-ray vector
    order = torch.randperm(1000, generator=gen).to(torch.int32).to(cuda_device)
    jobs = []
    for lo, hi in ((0, 512), (512, 512), (512, 1000)):  # the middle bucket is empty
        idx = order[lo:hi]
        jobs += [(tables[0], idx, 388), (tables[1], idx, 13), (tables[2], idx, 232),
                 (tables[3], idx, 7), (tables[4], idx, 1), (tables[0], idx, 0)]
    before = cuda.launch_counts["row_gather"]
    outs = row_gather_batch(jobs)
    torch.cuda.synchronize()
    assert cuda.launch_counts["row_gather"] == before + 1
    for (table, idx, w), out, ref in zip(jobs, outs, row_gather_batch_twin(jobs)):
        assert out.is_contiguous() and out.shape == (idx.shape[0], w)
        assert torch.equal(out, ref)
        assert torch.equal(out, row_gather(table, idx, w))


@pytest.mark.cuda
def test_batch_kernel_splits_past_its_job_capacity(cuda_device):
    """More jobs than the kernel's parameter space holds take one launch
    per full list, each still equal to the twin."""
    from tetranerf_torch.ops.gather import _max_jobs

    table = torch.arange(4000, dtype=torch.float32, device=cuda_device).reshape(400, 10)
    idx = torch.arange(0, 400, 7, dtype=torch.int32, device=cuda_device)
    jobs = [(table, idx, 1 + i % 10) for i in range(2 * _max_jobs() + 1)]
    before = cuda.launch_counts["row_gather"]
    outs = row_gather_batch(jobs)
    torch.cuda.synchronize()
    assert cuda.launch_counts["row_gather"] == before + 3
    for out, ref in zip(outs, row_gather_batch_twin(jobs)):
        assert torch.equal(out, ref)
