"""Counter-based PRNG: JAX's threefry2x32 on torch integer tensors.

The round step draws all its randomness as one uniform block from
``fold_in(PRNGKey(seed), t)``; reproducing ``jax.random`` bit for bit
is what lets cohorts, batch indices and packet-loss masks match the
JAX reference exactly. Keys are ``(2,)`` int64 tensors holding two
uint32 words; every word-level operation is masked back to 32 bits.
The recipes follow ``jax.random`` with ``jax_threefry_partitionable``:

  * ``PRNGKey(s)``    = (0, s & 0xFFFFFFFF)
  * ``fold_in(k, t)`` = threefry(k, (0, t))
  * ``split(k)[i]``   = threefry(k, (0, i))
  * ``uniform``       : bits[i] = a ^ b with (a, b) = threefry(k, (0, i));
                        the top 23 bits scaled into [0, 1), shifted and
                        scaled.
  * ``normal``        : sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1)),
                        with XLA's erf_inv polynomial. Its log1p is not
                        bitwise XLA's, so normals match to 3 ulps only.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key words ``(k0, k1)``. All operands are int64 tensors holding
    uint32 values (keys may be 0-dim); returns two such tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """(2,) int64 key from an integer seed: ``jax.random.PRNGKey`` in
    JAX's default 32-bit mode, which keeps only the low 32 bits."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _hash_counters(key: torch.Tensor, n: int):
    """threefry(key, (0, i)) for i in [0, n): the partitionable iota."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """Key derived from ``key`` and the integer ``data``."""
    d = torch.tensor([int(data) & _MASK], dtype=torch.int64,
                     device=key.device)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.cat([a, b])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) new keys."""
    a, b = _hash_counters(key, num)
    return torch.stack([a, b], dim=1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """uint32 random words (as int64) of the given shape."""
    a, b = _hash_counters(key, math.prod(shape))
    return (a ^ b).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval), bitwise ``jax.random.uniform``."""
    bits = random_bits(key, shape)
    # JAX puts 23 random mantissa bits under the exponent of 1.0 and
    # subtracts 1: m * 2**-23 for the 23-bit integer m, which float32
    # holds exactly. (An integer-to-float bit-cast has no vmap rule.)
    floats = (bits >> 9).to(torch.float32) * 2.0 ** -23
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's float32 erf_inv: M. Giles' approximation, degree 9 in w below 5
# and in sqrt(w) - 3 above it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's polynomial. Each Horner
    step is a fused multiply-add, as XLA's CPU backend emits it: the
    exact f32 product and the sum are taken in float64 and rounded once.
    ``torch.erfinv`` is another algorithm, up to ~90 ulps away in the
    tails; this is within 3 ulps of XLA's (its log1p differs)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef(i).double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 standard normals (``jax.random.normal`` to 3 ulps)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, minval=lo, maxval=1.0)
    return _erfinv(u) * float(np.float32(np.sqrt(2.0)))
