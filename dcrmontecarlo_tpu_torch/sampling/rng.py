"""Counter-hash RNG on torch tensors (port of ``dcrmontecarlo_tpu/sampling/rng.py``).

``value = mix32(lane ^ C_STREAM*stream ^ mix32(seed ^ C_COUNTER*counter))``,
then ``(h >> 8) * 2^-24``. The uniforms are a pure function of
``(seed, counter, stream, lane)`` and bit-identical to the JAX package's.

u32 values ride in int64 tensors masked to 32 bits: torch's uint32
coverage is partial. A product of a u32 value and a u32 constant can
reach 2^64, past int64, so :func:`mul32` multiplies by the constant's
signed 32-bit representative instead (``c - 2^32`` for ``c >= 2^31``):
the product is congruent mod 2^32, its magnitude stays below 2^63, and
the mask recovers the low 32 bits of the two's-complement result.
"""

import numpy as np
import torch

__all__ = ["mix32", "mul32", "counter_uniform", "counter_uniform_lanes",
           "stream_seed", "threefry_2x32", "shard_seed", "C_STREAM",
           "C_COUNTER", "MIX_M1", "MIX_M2"]

MASK32 = 0xFFFFFFFF
MIX_M1 = 0x7FEB352D
MIX_M2 = 0x846CA68B
C_STREAM = 0x9E3779B9     # golden-ratio odd constant
C_COUNTER = 0x85EBCA6B


def mul32(x, c: int):
    """``(x * c) mod 2^32`` for u32 values ``x`` (int64 tensor) and a
    python-int u32 constant ``c``."""
    c &= MASK32
    if c >= 1 << 31:
        c -= 1 << 32
    return (x * c) & MASK32


def mix32(x):
    """SplitMix32/murmur3-style 32-bit avalanche finalizer. ``x`` is an
    int64 tensor of u32 values, or an integer or numpy value (such as a
    ``np.uint32``), which becomes one."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.int64))
    x = x & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, MIX_M1)
    x = x ^ (x >> 15)
    x = mul32(x, MIX_M2)
    x = x ^ (x >> 16)
    return x


def _as_u32(v, device=None):
    t = torch.as_tensor(v, device=device)
    return t.to(torch.int64) & MASK32


def _to_unit(h):
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def counter_uniform_lanes(seed, counters, n_streams: int, lane_ids):
    """``(n_streams, L)`` uniforms from per-lane counters and lane ids.

    ``seed`` is a python int or 0-d tensor (any sign: only its low 32 bits
    count); ``counters`` and ``lane_ids`` are ``(L,)`` integer tensors.
    """
    ctr = _as_u32(counters)
    lane = _as_u32(lane_ids, ctr.device)
    seed = _as_u32(seed, ctr.device)
    stream = torch.arange(1, n_streams + 1, dtype=torch.int64,
                          device=ctr.device)[:, None]
    base = mix32(seed ^ mul32(ctr, C_COUNTER))[None, :]
    h = mix32(lane[None, :] ^ mul32(stream, C_STREAM) ^ base)
    return _to_unit(h)


def counter_uniform(seed, counter, n_streams: int, lanes: int, device=None):
    """``(n_streams, lanes)`` uniforms from a scalar ``(seed, counter)``."""
    ctr = torch.full((lanes,), int(counter) & MASK32, dtype=torch.int64,
                     device=device)
    return counter_uniform_lanes(
        seed, ctr, n_streams, torch.arange(lanes, device=device))


def stream_seed(seed: int) -> int:
    """The walk's int32-bit-pattern stream seed for a solve ``seed``.

    Mirrors ``solver/wost.py:1867-1870`` of the JAX package,
    ``bitcast_i32(kd[0] ^ mix32(kd[-1]))`` over the two u32 words of
    ``jax.random.PRNGKey(seed)``, which (64-bit mode off) are
    ``[0, seed mod 2^32]``.
    """
    kd = np.array([0, int(seed) & MASK32], np.uint32)
    word = int(kd[0]) ^ int(mix32(torch.tensor(int(kd[-1]))))
    return int(np.array(word, np.uint32).view(np.int32))


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


def threefry_2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the two-word ``key``, in numpy ``uint32`` arithmetic (wrapping adds):
    the block cipher under ``jax.random`` (``jax._src.prng.threefry2x32``).
    ``x0``, ``x1`` are integers or arrays of one shape; returns the two
    output words as ``uint32`` arrays of that shape."""
    u32 = lambda v: np.asarray(v, np.int64).astype(np.uint32)
    ks = (u32(key[0]), u32(key[1]))
    ks += (ks[0] ^ ks[1] ^ np.uint32(_THREEFRY_PARITY),)
    with np.errstate(over="ignore"):  # uint32 adds wrap, as intended
        x = [u32(x0) + ks[0], u32(x1) + ks[1]]
        for i in range(5):
            for r in _THREEFRY_ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return np.asarray(x[0]), np.asarray(x[1])


def shard_seed(seed: int, d: int) -> int:
    """The walk's int32-bit-pattern stream seed of global shard ``d`` of a
    sharded solve with ``seed``.

    Mirrors ``parallel/mesh.py:492-496`` of the JAX package:
    ``jax.random.fold_in(PRNGKey(seed), d)``, which is ``threefry_2x32``
    of the counter words ``[0, d]`` under the key ``[0, seed mod 2^32]``,
    then ``bitcast_i32(kd[0] ^ mix32(kd[-1]))`` of the folded key, as
    :func:`stream_seed` does with the unfolded one.
    """
    k0, k1 = threefry_2x32((0, int(seed) & MASK32), 0, int(d) & MASK32)
    word = int(k0) ^ int(mix32(torch.tensor(int(k1))))
    return int(np.array(word, np.uint32).view(np.int32))
