"""The port's threefry key schedule (``ops/rng.py``) against ``jax.random``,
bit for bit, on the CPU: ``key``, ``fold_in``, ``split`` and ``uniform`` at
the shapes and fold data the engine uses, and the golden values that
``chip_smoke.py`` checks on the card (where there is no jax)."""

import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu_torch.ops import rng, rng_cuda  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def key_words(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 5, -1])
def test_key_matches_jax(seed):
    assert tuple(rng.key(seed)) == key_words(jax.random.key(seed))


# per-bounce h, the hero fold, the jitter fold, a chunk fold, a sample
# counter far along a long session, and the largest 32-bit value
FOLDS = [0, 5, 0x0D15, 0xC0FFEE, 0xC40000 + 3, 123_456_789, 2**32 - 1]


@pytest.mark.parametrize("data", FOLDS)
def test_fold_in_matches_jax(data):
    for seed in (0, 7):
        want = key_words(jax.random.fold_in(jax.random.key(seed), data))
        assert tuple(rng.fold_in(rng.key(seed), data)) == want


def test_nested_folds_match_jax():
    """The engine's chain: session key -> sample -> bounce iteration."""
    jk, pk = jax.random.key(3), rng.key(3)
    for data in (41, 2, 0x0D15):
        jk, pk = jax.random.fold_in(jk, data), rng.fold_in(pk, data)
    assert tuple(pk) == key_words(jk)


@pytest.mark.parametrize("num", [2, 5])
def test_split_matches_jax(num):
    want = [tuple(int(v) for v in row) for row in
            np.asarray(jax.random.key_data(jax.random.split(
                jax.random.key(11), num)))]
    assert [tuple(k) for k in rng.split(rng.key(11), num)] == want


@pytest.mark.parametrize("shape", [(4, 7), (4, 1001), (1001,),
                                   (2**16 + 3,), (4, 2**16 + 3), (3, 5, 7)])
def test_uniform_matches_jax_bitwise(shape):
    jk = jax.random.fold_in(jax.random.key(9), 2)
    want = jax.random.uniform(jk, shape)
    got = rng.uniform_ref(rng.fold_in(rng.key(9), 2), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def test_uniform_edges_of_the_conversion():
    """All-zero and all-one bits give 0.0 and 1 - 2**-23 (23 random
    mantissa bits), the ends of jax.random.uniform's range."""
    ones = torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64)
    got = rng.bits_to_unit_float(ones)
    assert got[0].item() == 0.0
    assert got[1].item() == 1.0 - 2.0 ** -23


def test_uniform_wrapper_runs_the_plain_version_on_the_cpu():
    k = rng.fold_in(rng.key(1), 4)
    before = rng_cuda.uniform.launches
    got = rng_cuda.uniform(k, (4, 33), "cpu")
    assert rng_cuda.uniform.launches == before       # no kernel on the CPU
    assert torch.equal(got, rng.uniform_ref(k, (4, 33)))
    with pytest.raises(ValueError):
        rng_cuda.uniform(k, (4,), "meta")


def _chip_smoke_golden():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.RNG_GOLDEN


def test_chip_smoke_golden_values_are_jax():
    g = _chip_smoke_golden()
    k = jax.random.key(g["seed"])
    for data, words in g["fold_in"].items():
        assert key_words(jax.random.fold_in(k, data)) == tuple(words)
    u = bits(jax.random.uniform(jax.random.fold_in(k, g["uniform_fold"]),
                                g["uniform_shape"]))
    for r, row in enumerate(g["uniform_bits"]):
        assert tuple(int(b) for b in u[r, :len(row)]) == tuple(row)
    hero = bits(jax.random.uniform(jax.random.fold_in(k, 0x0D15),
                                   (g["uniform_shape"][1],)))
    assert tuple(int(b) for b in hero[:len(g["hero_bits"])]) == \
        tuple(g["hero_bits"])
    # and the port reproduces them
    pk = rng.key(g["seed"])
    for data, words in g["fold_in"].items():
        assert tuple(rng.fold_in(pk, data)) == tuple(words)
