"""The port's threefry (``repro_torch.training.prng``) against ``jax.random``
bit for bit — keys, ``fold_in``, ``split``, the random bits, ``uniform``,
``bernoulli`` and ``randint`` for several seeds and shapes — and the
port's ``batch_at`` against the reference's, with no monkeypatch, for seeds
{0, 1, 2³¹−1}, steps {0, 1, 17, 1000} and vocab sizes {97, 256, 151936}."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.training import data as jdata
from repro_torch.training import data as tdata
from repro_torch.training import prng

SEEDS = (0, 1, 42, 2 ** 31 - 1, 2 ** 32 - 1)
SHAPES = ((1,), (7,), (3, 5), (2, 3, 4))


def _eq(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_match_jax(seed):
    k, pk = jax.random.PRNGKey(seed), prng.key(seed)
    _eq(pk, k)
    for data in (0, 1, 17, 1000, 2 ** 31, 2 ** 32 - 1):
        _eq(prng.fold_in(pk, data), jax.random.fold_in(k, data))
    for num in (2, 3, 8):
        _eq(prng.split(pk, num), jax.random.split(k, num))
    with pytest.raises(OverflowError):
        prng.fold_in(pk, -1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_uniform_bernoulli_match_jax(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    pk = prng.fold_in(prng.key(seed), 5)
    _eq(prng.random_bits(pk, shape), jax.random.bits(k, shape, jnp.uint32))
    _eq(prng.uniform(pk, shape), jax.random.uniform(k, shape))
    for p in (0.05, 0.5, 0.999):
        _eq(prng.bernoulli(pk, p, shape), jax.random.bernoulli(k, p, shape))


@pytest.mark.parametrize("bounds", [(0, 97), (0, 256), (0, 151936), (-7, 9), (3, 4),
                                    (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)])
def test_randint_matches_jax(bounds):
    lo, hi = bounds
    for seed in SEEDS[:3]:
        k, pk = jax.random.PRNGKey(seed), prng.key(seed)
        for shape in SHAPES:
            _eq(prng.randint(pk, shape, lo, hi),
                jax.random.randint(k, shape, lo, hi, dtype=jnp.int32))


@pytest.mark.parametrize("vocab", [97, 256, 151936])
@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_batch_at_is_the_reference_batch(seed, vocab):
    for step in (0, 1, 17, 1000):
        want = jdata.batch_at(jdata.DataConfig(vocab, 48, 6, seed), step)
        got = tdata.batch_at(tdata.DataConfig(vocab, 48, 6, seed), step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for key in got:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
