"""The port's ``Wave`` against the JAX package's: twins of
``tests/test_wave.py``, each also held equal to the JAX type on the same
operands (exact: both are the same float32 numpy arithmetic)."""

import numpy as np
import pytest

pytest.importorskip("torch")

from pathtracing_spectrum_tpu import Wave as JWave  # noqa: E402
from pathtracing_spectrum_tpu_torch import Wave  # noqa: E402


def both(fn):
    """``fn`` applied with each package's Wave; asserts the two results are
    equal bit for bit and returns the port's."""
    got, want = fn(Wave), fn(JWave)
    assert type(got).__name__ == type(want).__name__ == "Wave"
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.dtype == want.data.dtype == np.float32
    return got


def test_binary_ops_min_size_with_excess_copy():
    s = both(lambda W: W([1.0, 2.0, 3.0]) + W([10.0, 20.0]))
    assert s.size() == 3
    assert np.allclose(s.data, [11.0, 22.0, 3.0])  # excess copied unchanged
    m = both(lambda W: W([1.0, 2.0, 3.0]) * W([10.0, 20.0]))
    assert np.allclose(m.data, [10.0, 40.0, 3.0])
    d = both(lambda W: W([1.0, 2.0, 3.0]) - W([10.0, 20.0]))
    assert np.allclose(d.data, [-9.0, -18.0, 3.0])


def test_scalar_ops():
    assert np.allclose(both(lambda W: W([1.0, 2.0]) * 2.0).data, [2.0, 4.0])
    assert np.allclose(both(lambda W: W([1.0, 2.0]) / 2.0).data, [0.5, 1.0])


def test_inplace_ops_touch_overlap_only():
    def add(W):
        a = W([1.0, 2.0, 3.0])
        a += W([1.0, 1.0])
        return a

    def add_sub(W):
        a = add(W)
        a -= W([1.0, 1.0, 1.0, 5.0])
        return a

    assert np.allclose(both(add).data, [2.0, 3.0, 3.0])
    assert np.allclose(both(add_sub).data, [1.0, 2.0, 2.0])


def test_initialize_resets_to_zero():
    def init(W):
        a = W([1.0, 2.0])
        a.initialize(4)
        return a

    a = both(init)
    assert a.size() == 4 and len(a) == 4
    assert np.allclose(a.data, 0.0)
    assert repr(a) == repr(init(JWave)) == "Wave([0.0, 0.0, 0.0, 0.0])"
