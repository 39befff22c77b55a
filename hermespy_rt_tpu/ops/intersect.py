"""Ray-triangle nearest-hit queries (Möller–Trumbore) — jnp reference path.

Semantics parity with the reference brute-force scan
(``/root/reference/src/compute_paths.c:237-287``): every ray is tested against
every triangle with ``FLT_EPSILON``-tolerant barycentric bounds, the nearest
hit with ``t > eps`` (and ``t < 1e9``, the reference's ``dist`` init) wins,
and ties resolve to the lowest triangle index (the reference's first-strict-min
update order).  Misses return index ``-1``.

Array-first redesign: instead of a per-ray scalar loop the query is a dense
``[rays x triangles]`` computation reduced over the triangle axis.  This module
is the always-available jnp implementation (used for small batches, CPU tests
and as the golden model for the Pallas kernel in
:mod:`hermespy_rt_tpu.ops.intersect_pallas`); it chunks the ray axis through
``lax.map`` to bound the materialised ``[chunk, T]`` intermediates.

The returned ``(t, idx)`` are treated as non-differentiable hit *decisions*;
the tracer re-derives differentiable hit quantities by gathering the hit
triangle and recomputing (see :func:`recompute_hit_t`), which makes gradients
flow without a custom VJP around the argmin.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..scene.model import TriangleSoA
from .geometry import cross3, dot3

__all__ = ["intersect_jnp", "recompute_hit_t", "MISS", "FLT_EPS", "T_MAX"]

FLT_EPS = 1.1920928955078125e-07  # __FLT_EPSILON__, matches the C tolerance
T_MAX = 1e9                       # reference 'dist' init (compute_paths.c:251)
MISS = -1


def _mt_block(o, d, v0, e1, e2):
    """Möller–Trumbore terms for a [C]-ray x [T]-triangle block.

    Returns (t[C,T], valid[C,T]) in float32, epsilon semantics identical to
    /root/reference/src/compute_paths.c:256-275.
    """
    pvec = cross3(d[:, None, :], e2[None, :, :])          # [C,T,3]
    det = jnp.sum(e1[None, :, :] * pvec, axis=-1)         # [C,T]
    s = o[:, None, :] - v0[None, :, :]                    # [C,T,3]
    inv_det = 1.0 / jnp.where(det == 0, 1.0, det)
    u = jnp.sum(s * pvec, axis=-1) * inv_det
    qvec = jnp.cross(s, e1[None, :, :])                   # [C,T,3]
    v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det
    valid = ((jnp.abs(det) >= FLT_EPS)
             & (u >= -FLT_EPS) & (u <= 1.0 + FLT_EPS)
             & (v >= -FLT_EPS) & (u + v <= 1.0 + FLT_EPS)
             & (t > FLT_EPS) & (t < T_MAX))
    return t, valid


def _nearest(t, valid, base_idx: int = 0):
    """Nearest-hit reduction over the triangle axis with first-min ties."""
    t_masked = jnp.where(valid, t, jnp.inf)
    arg = jnp.argmin(t_masked, axis=-1)                   # first occurrence
    tmin = jnp.take_along_axis(t_masked, arg[:, None], axis=-1)[:, 0]
    hit = jnp.isfinite(tmin)
    idx = jnp.where(hit, arg.astype(jnp.int32) + base_idx, MISS)
    return jnp.where(hit, tmin, jnp.inf), idx


@partial(jax.jit, static_argnames=("chunk_size",))
def intersect_jnp(o: jax.Array, d: jax.Array, tris: TriangleSoA,
                  chunk_size: int = 4096,
                  exclude=None) -> Tuple[jax.Array, jax.Array]:
    """Nearest hit for rays ``(o, d)`` f32[R,3] against all scene triangles.

    Returns ``(t, idx)``: ``t`` f32[R] (parametric distance in units of |d|,
    +inf on miss) and ``idx`` i32[R] (global triangle index, -1 on miss).
    ``exclude`` (i32[R], optional) suppresses one triangle per ray — the one
    the ray provably originates on (self-hit exclusion); -1 excludes none.
    """
    R = o.shape[0]
    v0, e1, e2 = tris.v0, tris.e1, tris.e2
    if exclude is not None:
        exclude = jax.lax.stop_gradient(jnp.asarray(exclude, jnp.int32))
    tri_ids = jnp.arange(v0.shape[0], dtype=jnp.int32)

    def one_chunk(args):
        if exclude is None:
            oc, dc = args
            exc = None
        else:
            oc, dc, exc = args
        t, valid = _mt_block(oc, dc, v0, e1, e2)
        if exc is not None:
            valid = valid & (tri_ids[None, :] != exc[:, None])
        return _nearest(t, valid)

    if R <= chunk_size:
        return one_chunk((o, d) if exclude is None else (o, d, exclude))

    # Pad to a chunk multiple, map chunks, then slice back.
    pad = (-R) % chunk_size
    o_p = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)]) if pad else o
    d_p = jnp.concatenate([d, jnp.zeros((pad, 3), d.dtype)]) if pad else d
    n_chunks = (R + pad) // chunk_size
    o_c = o_p.reshape(n_chunks, chunk_size, 3)
    d_c = d_p.reshape(n_chunks, chunk_size, 3)
    if exclude is None:
        t, idx = jax.lax.map(one_chunk, (o_c, d_c))
    else:
        e_p = (jnp.concatenate([exclude, jnp.full((pad,), -1, jnp.int32)])
               if pad else exclude)
        e_c = e_p.reshape(n_chunks, chunk_size)
        t, idx = jax.lax.map(one_chunk, (o_c, d_c, e_c))
    return t.reshape(-1)[:R], idx.reshape(-1)[:R]


def recompute_hit_t(o, d, hit_idx, tris: TriangleSoA):
    """Differentiable parametric distance of an already-decided hit.

    Gathers the hit triangle (``hit_idx`` clamped; callers mask misses) and
    recomputes ``t = (e2 . (s x e1)) / (e1 . (d x e2))`` so gradients flow
    into ray origin/direction and scene vertices while the discrete hit choice
    stays fixed (stop-gradient through ``hit_idx``).
    """
    safe = jnp.maximum(hit_idx, 0)
    v0 = tris.v0[safe]
    e1 = tris.e1[safe]
    e2 = tris.e2[safe]
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    s = o - v0
    qvec = cross3(s, e1)
    inv_det = 1.0 / jnp.where(det == 0, 1.0, det)
    t = dot3(e2, qvec) * inv_det
    return jnp.where(hit_idx >= 0, t, jnp.inf)
