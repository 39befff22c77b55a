"""Geometric primitives: launch-direction generation and vector helpers.

The reference generates per-TX launch directions on a Fibonacci sphere with
mixed float/double trigonometry (``/root/reference/src/compute_paths.c:442-456``):
``k = path + 0.5f`` (f32), ``phi = acos(1 - 2k/N)`` (f64 acos of an f32
argument), ``theta = pi*(1+sqrt(5))*k`` (f32), and the direction components are
f64 products truncated to f32.  :func:`fibonacci_sphere` reproduces that
rounding chain bit-for-bit in numpy so parity tests see identical launch rays.
Directions are constants (no gradient flows through them), so host-side numpy
is the right place to compute them.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["fibonacci_sphere", "dot3", "cross3", "normalize3", "reflect3",
           "fast_acos"]

_PI32 = np.float32(3.14159265358979323846)


def fibonacci_sphere(num_paths: int) -> np.ndarray:
    """Deterministic unit launch directions, f32[num_paths, 3].

    Bit-exact with /root/reference/src/compute_paths.c:443-451 (including the
    f32 wrap-around of ``theta`` at large path indices).
    """
    k = np.arange(num_paths, dtype=np.float32) + np.float32(0.5)
    # 1.f - 2.f * k / num_paths evaluated in f32 (C float arithmetic).
    arg = np.float32(1.0) - (np.float32(2.0) * k) / np.float32(num_paths)
    phi32 = np.arccos(arg.astype(np.float64)).astype(np.float32)
    sqrt5 = np.sqrt(np.float32(5.0), dtype=np.float32)
    theta32 = (_PI32 * (np.float32(1.0) + sqrt5)) * k  # f32 multiply chain
    theta64 = theta32.astype(np.float64)
    phi64 = phi32.astype(np.float64)
    d = np.stack([
        np.cos(theta64) * np.sin(phi64),
        np.sin(theta64) * np.sin(phi64),
        np.cos(phi64),
    ], axis=-1)
    return d.astype(np.float32)


def dot3(a, b):
    """Row-wise 3-vector dot product over the trailing axis."""
    return jnp.sum(a * b, axis=-1)


def cross3(a, b):
    return jnp.cross(a, b)


def normalize3(v, eps: float = 0.0):
    n = jnp.sqrt(dot3(v, v))
    return v / jnp.maximum(n, eps)[..., None] if eps else v / n[..., None]


def reflect3(d, n):
    """Specular reflection ``d' = d - 2 (d.n) n``
    (/root/reference/src/compute_paths.c:652-656)."""
    return d - 2.0 * dot3(d, n)[..., None] * n


# asin(x)/x ~ poly(x^2) on [0, 0.5], degree-5 least-squares fit on Chebyshev
# nodes; max abs error 2.4e-9 — below 1 ulp of float32 acos outputs.
_ASIN_POLY = tuple(np.float32(v) for v in (
    0.999999996, 0.166667869, 0.074945353, 0.0455389549, 0.0239094263,
    0.0425537353))
_HALF_PI = np.float32(np.pi / 2)


def _asin_core(x, x2):
    c0, c1, c2, c3, c4, c5 = _ASIN_POLY
    p = c5
    for c in (c4, c3, c2, c1, c0):
        p = p * x2 + c
    return x * p


def fast_acos(x):
    """float32 arccos as a polynomial (mul/add/sqrt only, no atan2 chain)
    with error below 1 ulp of the f32 result.  Every backend uses it, and
    the parity tests pin it.

    Uses asin(x) for |x| <= 0.5 and the identity
    ``acos(1-2s) = 2 asin(sqrt(s))`` for the outer range, which keeps full
    accuracy near the +-1 endpoints (where the tracer's near-normal-incidence
    rays live).  Gradient matches arccos away from +-1 and is finite at the
    clamp.
    """
    ax = jnp.abs(x)
    small = ax <= 0.5

    # |x| <= 0.5: acos(x) = pi/2 - asin(x)
    asin_inner = _asin_core(x, x * x)

    # |x| > 0.5: acos(|x|) = 2 asin(sqrt((1-|x|)/2))
    s = jnp.maximum(0.5 * (1.0 - ax), 0.0)
    r = jnp.sqrt(s)
    acos_pos = 2.0 * _asin_core(r, s)                # acos(|x|), |x| > 0.5
    acos_outer = jnp.where(x >= 0, acos_pos, np.float32(np.pi) - acos_pos)

    return jnp.where(small, _HALF_PI - asin_inner, acos_outer)
