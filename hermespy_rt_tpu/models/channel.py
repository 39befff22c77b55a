"""Channel models on top of the path tracer.

The reference stops at per-path parameters (``ChannelInfo``); its consumer
(HermesPy) turns them into channel realisations.  This module provides that
next layer as array programs so the framework is usable end-to-end: band-limited
channel impulse responses (tapped delay lines), narrowband coefficients with
Doppler evolution, and summary statistics — all jit/vmap/grad-compatible.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..tracer import PathsResult

__all__ = ["combine_paths", "cir", "narrowband_coefficients", "path_gain_db",
           "rms_delay_spread"]


def combine_paths(result: PathsResult, polarization: str = "te"
                  ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Concatenate LoS + scatter paths into flat per-link arrays.

    Returns ``(a, tau, freq_shift)`` with shape ``[nrx, ntx, 1 + K]``,
    complex64/f32.  ``polarization`` selects "te" or "tm" gains.
    """
    los, scat = result.los, result.scatter
    a_l = getattr(los, f"a_{polarization}")
    a_s = getattr(scat, f"a_{polarization}")
    a = jnp.concatenate([a_l, a_s], axis=-1)
    tau = jnp.concatenate([los.tau, scat.tau], axis=-1)
    nu = jnp.concatenate([los.freq_shift, scat.freq_shift], axis=-1)
    return a, tau, nu


def cir(result: PathsResult, sampling_rate: float, num_taps: int,
        time: float = 0.0, polarization: str = "te") -> jax.Array:
    """Band-limited channel impulse response (tapped delay line).

    Each path contributes ``a * exp(j 2 pi nu t) * sinc(tap - tau * fs)`` —
    the standard fractional-delay sinc interpolation of the continuous CIR
    onto a uniform tap grid at ``sampling_rate``.

    Returns complex64 ``[nrx, ntx, num_taps]``.
    """
    a, tau, nu = combine_paths(result, polarization)
    fs = jnp.float32(sampling_rate)
    t = jnp.float32(time)
    phase = jnp.exp(2j * jnp.pi * (nu * t)).astype(jnp.complex64)
    taps = jnp.arange(num_taps, dtype=jnp.float32)             # [T]
    # [nrx, ntx, P, T] sinc kernel; zero-gain paths contribute nothing.
    frac = taps[None, None, None, :] - (tau * fs)[..., None]
    kernel = jnp.sinc(frac)
    contrib = (a * phase)[..., None] * kernel
    return jnp.sum(contrib, axis=-2)


def narrowband_coefficients(result: PathsResult, carrier_frequency_ghz,
                            times, polarization: str = "te") -> jax.Array:
    """Time-evolving narrowband channel coefficient
    ``h(t) = sum_p a_p exp(-j 2 pi f tau_p) exp(j 2 pi nu_p t)``.

    ``times`` is f32[T] seconds; returns complex64 ``[nrx, ntx, T]``.
    """
    a, tau, nu = combine_paths(result, polarization)
    f_hz = jnp.float32(carrier_frequency_ghz) * jnp.float32(1e9)
    static = a * jnp.exp(-2j * jnp.pi * (f_hz * tau)).astype(jnp.complex64)
    t = jnp.asarray(times, jnp.float32)
    rot = jnp.exp(2j * jnp.pi * nu[..., None] * t[None, None, None, :])
    return jnp.sum(static[..., None] * rot.astype(jnp.complex64), axis=-2)


def path_gain_db(result: PathsResult, polarization: str = "te") -> jax.Array:
    """Total received power over all paths, in dB, per (rx, tx) link."""
    a, _, _ = combine_paths(result, polarization)
    p = jnp.sum(jnp.abs(a) ** 2, axis=-1)
    return 10.0 * jnp.log10(jnp.maximum(p, 1e-30))


def rms_delay_spread(result: PathsResult, polarization: str = "te"
                     ) -> jax.Array:
    """Power-weighted RMS delay spread per (rx, tx) link, seconds."""
    a, tau, _ = combine_paths(result, polarization)
    p = jnp.abs(a) ** 2
    w = p / jnp.maximum(jnp.sum(p, axis=-1, keepdims=True), 1e-30)
    mean = jnp.sum(w * tau, axis=-1, keepdims=True)
    return jnp.sqrt(jnp.sum(w * (tau - mean) ** 2, axis=-1))
