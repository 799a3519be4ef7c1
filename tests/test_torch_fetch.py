"""K2's plain version (``fetch_rows_ref``) vs the TPU fetch kernel
``ops/fetch_pallas.py::fetch_rows_pallas`` in interpret mode, at the cases
of ``tests/test_fetch_kernel.py``, and the wrapper's CPU dispatch; the
kernel itself is held against its plain version in ``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu.ops.fetch_pallas import (  # noqa: E402
    fetch_rows_pallas)
from pathtracing_spectrum_tpu_torch.ops import fetch_cuda  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops.fetch_cuda import (  # noqa: E402
    fetch_rows, fetch_rows_ref)


def both(idx, table):
    want = np.asarray(fetch_rows_pallas(jnp.asarray(idx), jnp.asarray(table),
                                        interpret=True))
    got = fetch_rows_ref(torch.from_numpy(idx), torch.from_numpy(table))
    return got, want


@pytest.mark.parametrize("t,f,n", [(36, 48, 500), (2300, 30, 1500),
                                   (36, 31, 4096)])
def test_ref_matches_pallas(t, f, n):
    rng = np.random.default_rng(t)
    table = rng.normal(size=(t, f)).astype(np.float32)
    idx = rng.integers(0, t, n).astype(np.int32)
    got, want = both(idx, table)
    assert got.shape == (f, n) and got.is_contiguous()
    # a fetch copies values: the one-hot product of the TPU kernel adds only
    # exact zeros, so both sides hold the table's bits
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[idx].T)


def test_out_of_range_is_zero():
    table = np.arange(80, dtype=np.float32).reshape(10, 8) + 1.0
    idx = np.array([0, 9, -1, 10, 5, -7, 1 << 20], np.int32)
    got, want = both(idx, table)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, [2, 3, 5, 6]], 0.0)
    np.testing.assert_array_equal(got.numpy()[:, 1], table[9])


def test_wrapper_takes_plain_version_on_cpu():
    table = torch.ones((4, 3))
    idx = torch.tensor([0, 3, 4], dtype=torch.int32)
    before = fetch_cuda.fetch_rows.launches
    out = fetch_rows(idx, table)
    assert fetch_cuda.fetch_rows.launches == before   # no kernel on the CPU
    np.testing.assert_array_equal(out.numpy()[:, 2], 0.0)
