"""Counter-hash RNG of the PyTorch port against the JAX package.

The walk's uniforms are a pure function of (seed, counter, stream, lane),
so the port must reproduce the JAX hash bit for bit, including values
with the high bit set (the port carries u32 values in int64 tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.sampling import rng as jrng
from dcrmontecarlo_tpu_torch.sampling import rng as trng

torch.set_num_threads(1)

_HIGH = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1], np.uint32)


def _u32_samples(seed, n=4096):
    r = np.random.default_rng(seed)
    return np.concatenate([_HIGH, r.integers(0, 2**32, n, dtype=np.uint64)
                           .astype(np.uint32)])


def _t(u32):
    return torch.from_numpy(u32.astype(np.int64))


def test_mul32_keeps_low_32_bits():
    x = _u32_samples(0)
    for c in (trng.MIX_M1, trng.MIX_M2, trng.C_STREAM, trng.C_COUNTER):
        want = (x.astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = trng.mul32(_t(x), c).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_mix32_bit_identical():
    x = _u32_samples(1)
    want = np.asarray(jrng.mix32(jnp.asarray(x)))
    got = trng.mix32(_t(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**31 + 5, 2**32 - 1])
def test_counter_uniform_lanes_bit_identical(seed):
    r = np.random.default_rng(seed % 1000)
    ctr = _u32_samples(seed % 97, 1000)
    lanes = _u32_samples(seed % 89, 1000)
    r.shuffle(lanes)
    want = np.asarray(jrng.counter_uniform_lanes(
        np.uint32(seed), jnp.asarray(ctr), 5, jnp.asarray(lanes)))
    got = trng.counter_uniform_lanes(seed, _t(ctr), 5, _t(lanes)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("counter", [0, 3, 2**31 + 11])
def test_counter_uniform_bit_identical(counter):
    want = np.asarray(jrng.counter_uniform(np.uint32(12345),
                                           np.uint32(counter), 4, 512))
    got = trng.counter_uniform(12345, counter, 4, 512).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 12345, 2**31 - 1, 2**31 + 5])
def test_stream_seed_matches_solver_derivation(seed):
    # solver/wost.py of the JAX package: bitcast_i32(kd[0] ^ mix32(kd[-1]))
    kd = jnp.asarray(jax.random.PRNGKey(seed), jnp.uint32).reshape(-1)
    want = int(jax.lax.bitcast_convert_type(kd[0] ^ jrng.mix32(kd[-1]),
                                            jnp.int32))
    assert trng.stream_seed(seed) == want


def test_uniforms_in_unit_interval():
    u = trng.counter_uniform_lanes(99, torch.arange(10000), 3,
                                   torch.arange(10000)).numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01
