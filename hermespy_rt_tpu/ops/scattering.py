"""Directive rough-surface scattering coefficients.

Vectorised, differentiable port of the reference ``scat_coefs``
(``/root/reference/src/compute_paths.c:346-415``): an ad-hoc directive model
("inspired by" Blaunstein et al., DOI 10.1109/TAP.2006.888422) with
directivity ``f = s * exp(-s1_alpha * |theta_s - theta_i|)``, a roughness mix
of specular/diffuse terms, a small roughness-phase rotation, and a unit-norm
energy normalisation guarded at ``norm > 1e-6``.

``s2``, ``s3`` and ``s3_alpha`` are unused, exactly as in the reference
(its ``TODO`` at /root/reference/src/compute_paths.c:414).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["scat_coefs"]


def scat_coefs(theta_s, theta_i, s, s1_alpha, cos_ts=None, cos_ti=None,
               sin_ti=None) -> Tuple[jax.Array, jax.Array,
                                     jax.Array, jax.Array]:
    """Complex (S_TE, S_TM) scattering coefficients.

    Args are broadcastable arrays: scattering angle ``theta_s`` (to the RX),
    incidence angle ``theta_i``, material scattering coefficient ``s`` and lobe
    width ``s1_alpha`` (float; the reference stores it as uint8 but only ever
    uses it in float expressions).  The tracer passes ``cos_ts``/``cos_ti``/
    ``sin_ti`` directly (they are the dot products the angles came from —
    avoids trig round-trips); when omitted they are computed from the angles.

    Returns ``(s_te_re, s_te_im, s_tm_re, s_tm_im)``.
    """
    cos_ts = jnp.cos(theta_s) if cos_ts is None else cos_ts
    cos_ti = jnp.cos(theta_i) if cos_ti is None else cos_ti
    sin_ti = jnp.sin(theta_i) if sin_ti is None else sin_ti

    f = s * jnp.exp(-s1_alpha * jnp.abs(theta_s - theta_i))

    roughness = 1.0 / (1.0 + s1_alpha)
    specular = roughness * cos_ts
    diffuse = (1.0 - roughness) * cos_ts

    te_re = f * (specular + diffuse)
    tm_re = f * (specular * cos_ti + diffuse)

    phase = s1_alpha * sin_ti * jnp.float32(0.1)
    sin_phase = jnp.sin(phase)
    te_im = te_re * sin_phase
    tm_im = tm_re * sin_phase

    norm2 = te_re * te_re + te_im * te_im + tm_re * tm_re + tm_im * tm_im
    norm = jnp.sqrt(jnp.where(norm2 > 0, norm2, 1.0))
    do_norm = norm > 1e-6
    inv = jnp.where(do_norm, 1.0 / jnp.where(do_norm, norm, 1.0), 1.0)
    return te_re * inv, te_im * inv, tm_re * inv, tm_im * inv
