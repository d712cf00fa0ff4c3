"""Counter-based random draws: the seeded sampler's generator.

A `Key` carries a 64-bit stream ``seed`` and a ``counter``. `key(seed)`
starts a stream, and `fold_in(key, n)` derives the key of an integer
``n`` under it (speculative decoding folds in the tick, the row and the
chunk position). The bits of element ``e`` of a draw are an integer hash
of (seed, counter, e): three rounds of a 32-bit mixer in torch int64
operations whose values stay in [0, 2^63), so one key gives the same
bits on the CPU and on the card, and every element is independent of
how the draw is batched beyond its index. The draws are held to replay,
to their distribution and to independence across counters, not to
``jax.random``'s bits.

    k = prng.key(3)
    u = prng.uniform(prng.fold_in(k, 7), (4, 5))        # float64 in [0, 1)
    ids = prng.categorical(prng.fold_in(k, 8), logits)  # Gumbel-max, last dim
"""
from __future__ import annotations

import dataclasses

import torch

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class Key:
    seed: int  # 64-bit stream id
    counter: int = 0


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def key(seed: int) -> Key:
    """The root key of the stream ``seed``."""
    return Key(_splitmix64(int(seed) & M64))


def fold_in(k: Key, n: int) -> Key:
    """The key of integer ``n`` under ``k``: a new stream (a hash of ``k``)
    at counter ``n``."""
    return Key(_splitmix64(k.seed ^ _splitmix64(k.counter)), int(n) & M64)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), in 16-bit halves so no product
    reaches 2^63."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def bits(k: Key, n: int, device=None) -> torch.Tensor:
    """``n`` 32-bit words (int64 values in [0, 2^32)), word ``e`` a hash of
    (seed, counter, e); ``n`` < 2^32."""
    r1 = _splitmix64(k.seed ^ _splitmix64(k.counter))
    r2 = _splitmix64(r1)
    x = torch.arange(n, dtype=torch.int64, device=device)
    x = _mix32(x ^ (r1 & M32))
    x = _mix32((x + (r1 >> 32)) & M32)
    return _mix32(x ^ (r2 & M32))


def _mantissa(k: Key, shape, nbits: int, device) -> torch.Tensor:
    """Integers in [0, 2^nbits) (nbits <= 53) from two words per element."""
    n = 1
    for s in shape:
        n *= int(s)
    w = bits(k, 2 * n, device).reshape(n, 2)
    hi = nbits // 2 + nbits % 2
    m = ((w[:, 0] >> (32 - hi)) << (nbits - hi)) | (w[:, 1] >> (32 - (nbits - hi)))
    return m.reshape(tuple(shape))


def uniform(k: Key, shape, device=None) -> torch.Tensor:
    """float64 uniforms in [0, 1), 53 random bits each."""
    return _mantissa(k, shape, 53, device).double() * 2.0 ** -53


def gumbel(k: Key, shape, device=None) -> torch.Tensor:
    """float64 standard Gumbel draws, -log(-log(u)) with u in the open
    interval (0, 1): u = (2m + 1) / 2^53 for a 52-bit m."""
    u = (2 * _mantissa(k, shape, 52, device) + 1).double() * 2.0 ** -53
    return -torch.log(-torch.log(u))


def categorical(k: Key, logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Draws from softmax(logits) along ``dim`` by the Gumbel-max trick
    (int64 indices). A fixed key and logits give a fixed draw, ties
    included."""
    g = gumbel(k, logits.shape, logits.device)
    return torch.argmax(logits.double() + g, dim=dim)


__all__ = ["Key", "bits", "categorical", "fold_in", "gumbel", "key", "uniform"]
