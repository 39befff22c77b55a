"""Pallas (Triton route) kernel for batched ray-triangle nearest-hit queries.

This is the hot op of the whole framework: the reference spends >99.9% of its
time in the equivalent scalar loop (``/root/reference/src/compute_paths.c:237-287``
called from the bounce loop, SURVEY.md §3.2 cost model).

Design: one program owns a block of ``block_rays`` rays, keeps their origin,
direction, range limit and running best ``(t, idx)`` in registers, and streams
the scene through a loop over tiles of ``block_tris`` triangles.  Each tile is
a ``[block_rays, block_tris]`` Möller–Trumbore evaluation in plain float32,
with the op order of :func:`hermespy_rt_tpu.ops.intersect._mt_block`, so the
kernel and the jnp reference can differ only by fma contraction.  The
first-min argmin folds into the same pass: within a tile the lowest column
achieving the tile minimum wins, across tiles a strict ``<`` keeps the earlier
tile — the reference's first-strict-min update order
(reference ``src/compute_paths.c:275-284``).

Two early exits:

* a block with no live ray (``live`` false, or a negative range limit)
  skips the triangle loop and reports all-miss — the tracer's dead-ray
  compaction (``TracerConfig.compact_rays``);
* ``any_hit=True`` stops a block once every live ray holds a hit within its
  range limit (occlusion queries only consume the existence of a hit).

The returned ``(t, idx)`` are hit *decisions*: the tracer re-derives all
differentiable quantities by gathering the chosen triangle, so this kernel
needs no custom VJP and runs identically under ``jax.grad``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..scene.model import TriangleSoA
from .intersect import FLT_EPS, T_MAX

__all__ = ["make_pallas_intersect", "pallas_intersect"]

_INF = np.float32(np.inf)
_NO_IDX = np.int32(2**31 - 1)

# tuned on an H100 at the street and city scenes (PERF.md: a 32 x 32 tile
# with 4 warps was fastest on both of 27 tile/warp combinations)
BLOCK_RAYS = 32
BLOCK_TRIS = 32
NUM_WARPS = 4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def check_block_sizes(block_rays, block_tris) -> None:
    """The kernel's tiles must be power-of-two ints (Triton block shapes);
    ``bool`` is not a size."""
    for name, v in (("block_rays", block_rays), ("block_tris", block_tris)):
        if (isinstance(v, bool) or not isinstance(v, int) or v <= 0
                or v & (v - 1)):
            raise ValueError(f"{name} must be a power-of-two int, got {v!r}")


def _kernel(tri_ref, ray_ref, ex_ref, t_ref, i_ref, *, block_tris: int,
            n_tiles: int, any_hit: bool):
    """One ray block against every triangle tile.

    ``tri_ref`` f32[9, Tpad]: rows v0, e1, e2 (x, y, z each).
    ``ray_ref`` f32[8, BR] block: rows d, o, t_lim, pad.  ``t_lim < 0``
    marks a dead ray.  ``ex_ref`` i32[BR]: excluded triangle per ray."""
    dx, dy, dz = ray_ref[0, :], ray_ref[1, :], ray_ref[2, :]
    ox, oy, oz = ray_ref[3, :], ray_ref[4, :], ray_ref[5, :]
    t_lim = ray_ref[6, :]
    excl = ex_ref[...]
    live = t_lim >= 0.0
    col = (lambda x: x[:, None])
    row = (lambda x: x[None, :])

    def tile(j, best_t, best_i):
        start = j * block_tris
        ld = lambda k: row(tri_ref[k, pl.ds(start, block_tris)])
        v0x, v0y, v0z = ld(0), ld(1), ld(2)
        e1x, e1y, e1z = ld(3), ld(4), ld(5)
        e2x, e2y, e2z = ld(6), ld(7), ld(8)
        # pvec = d x e2; det = e1 . pvec (intersect._mt_block order)
        px = col(dy) * e2z - col(dz) * e2y
        py = col(dz) * e2x - col(dx) * e2z
        pz = col(dx) * e2y - col(dy) * e2x
        det = e1x * px + e1y * py + e1z * pz
        sx, sy, sz = col(ox) - v0x, col(oy) - v0y, col(oz) - v0z
        inv_det = 1.0 / jnp.where(det == 0, 1.0, det)
        u = (sx * px + sy * py + sz * pz) * inv_det
        # qvec = s x e1
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = (col(dx) * qx + col(dy) * qy + col(dz) * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ids = start + jax.lax.broadcasted_iota(jnp.int32, (1, block_tris), 1)
        valid = ((jnp.abs(det) >= FLT_EPS)
                 & (u >= -FLT_EPS) & (u <= 1.0 + FLT_EPS)
                 & (v >= -FLT_EPS) & (u + v <= 1.0 + FLT_EPS)
                 & (t > FLT_EPS) & (t < T_MAX)
                 & (t <= col(t_lim)) & (ids != col(excl)))
        t_m = jnp.where(valid, t, _INF)
        tile_t = jnp.min(t_m, axis=1)
        tile_i = jnp.min(jnp.where(t_m == col(tile_t), ids, _NO_IDX), axis=1)
        better = tile_t < best_t                      # strict: ties keep
        return (jnp.where(better, tile_t, best_t),    # the earlier tile
                jnp.where(better, tile_i, best_i))

    best_t = jnp.full(t_lim.shape, _INF, jnp.float32)
    best_i = jnp.full(t_lim.shape, _NO_IDX, jnp.int32)
    if any_hit:
        def pending(best_i):
            return jnp.max((live & (best_i == _NO_IDX)).astype(jnp.int32))

        def cond(carry):
            j, _, best_i = carry
            return (j < n_tiles) & (pending(best_i) > 0)

        def body(carry):
            j, best_t, best_i = carry
            return (j + 1,) + tile(j, best_t, best_i)

        _, best_t, best_i = jax.lax.while_loop(
            cond, body, (jnp.int32(0), best_t, best_i))
    else:
        n_eff = jnp.where(jnp.max(live.astype(jnp.int32)) > 0,
                          jnp.int32(n_tiles), jnp.int32(0))
        best_t, best_i = jax.lax.fori_loop(
            0, n_eff, lambda j, c: tile(j, *c), (best_t, best_i))
    t_ref[...] = best_t
    i_ref[...] = jnp.where(best_i == _NO_IDX, -1, best_i)


def _tri_rows(tris: TriangleSoA, t_pad: int) -> jax.Array:
    """f32[9, t_pad]: v0, e1, e2 rows; zero padding triangles (det == 0)
    never hit."""
    g = jnp.concatenate([tris.v0, tris.e1, tris.e2], axis=-1).T
    g = jax.lax.stop_gradient(g.astype(jnp.float32))
    return jnp.pad(g, ((0, 0), (0, t_pad - g.shape[1])))


@functools.partial(jax.jit, static_argnames=(
    "has_t_max", "any_hit", "block_rays", "block_tris", "interpret"))
def _intersect_impl(o, d, tris, t_max, exclude, live, *, has_t_max: bool,
                    any_hit: bool, block_rays: int, block_tris: int,
                    interpret: bool):
    R = o.shape[0]
    r_pad = _round_up(max(R, block_rays), block_rays)
    t_pad = _round_up(tris.v0.shape[0], block_tris)
    t_lim = jnp.full((R,), _INF, jnp.float32)
    if has_t_max:
        t_lim = jnp.broadcast_to(
            jax.lax.stop_gradient(jnp.asarray(t_max, jnp.float32)), (R,))
    if live is not None:
        t_lim = jnp.where(live, t_lim, -1.0)
    rays = jnp.concatenate(
        [jax.lax.stop_gradient(d).T, jax.lax.stop_gradient(o).T,
         t_lim[None], jnp.zeros((1, R), jnp.float32)], axis=0)
    rays = jnp.pad(rays, ((0, 0), (0, r_pad - R)))
    rays = rays.at[6, R:].set(-1.0)                 # padding rays are dead
    ex = (jnp.full((R,), -1, jnp.int32) if exclude is None
          else jax.lax.stop_gradient(jnp.asarray(exclude, jnp.int32)))
    ex = jnp.pad(ex, (0, r_pad - R), constant_values=-1)

    kern = functools.partial(_kernel, block_tris=block_tris,
                             n_tiles=t_pad // block_tris, any_hit=any_hit)
    row = pl.BlockSpec((block_rays,), lambda i: (i,))
    t_out, i_out = pl.pallas_call(
        kern,
        grid=(r_pad // block_rays,),
        in_specs=[pl.BlockSpec((9, t_pad), lambda i: (0, 0)),
                  pl.BlockSpec((8, block_rays), lambda i: (0, i)), row],
        out_specs=[row, row],
        out_shape=[jax.ShapeDtypeStruct((r_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((r_pad,), jnp.int32)],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="intersect_nearest",
    )(_tri_rows(tris, t_pad), rays, ex)
    return t_out[:R], i_out[:R]


def pallas_intersect(o: jax.Array, d: jax.Array, tris: TriangleSoA,
                     t_max=None, exclude=None, live=None,
                     any_hit: bool = False,
                     block_rays: int = BLOCK_RAYS,
                     block_tris: int = BLOCK_TRIS,
                     interpret: bool = False) -> Tuple[jax.Array, jax.Array]:
    """Nearest hit of rays (o, d) f32[R,3] against the scene; returns
    (t f32[R] (+inf miss), idx i32[R] (-1 miss)) with the semantics of
    :func:`hermespy_rt_tpu.ops.intersect.intersect_jnp` followed by the
    ``t <= t_max`` filter.

    ``t_max`` (scalar or f32[R]) restricts the query to hits with
    ``t <= t_max``; ``exclude`` (i32[R]) suppresses one triangle per ray;
    ``live`` (bool[R]) marks rays whose result is consumed — results of dead
    rays are unspecified.  ``any_hit`` may return any qualifying hit instead
    of the nearest.  ``interpret=True`` runs the kernel in the Pallas
    interpreter (CPU tests)."""
    check_block_sizes(block_rays, block_tris)
    return _intersect_impl(
        o, d, tris, jnp.zeros((), jnp.float32) if t_max is None else t_max,
        exclude, live, has_t_max=t_max is not None, any_hit=bool(any_hit),
        block_rays=int(block_rays), block_tris=int(block_tris),
        interpret=bool(interpret))


def make_pallas_intersect(tris: TriangleSoA, block_rays: int = BLOCK_RAYS,
                          block_tris: int = BLOCK_TRIS,
                          interpret: bool = False):
    """Bind a scene into an ``intersect_fn(o, d, t_max=None, exclude=None,
    live=None, any_hit=False) -> (t, idx)`` closure."""
    check_block_sizes(block_rays, block_tris)

    def intersect_fn(o, d, t_max=None, exclude=None, live=None,
                     any_hit=False):
        return pallas_intersect(o, d, tris, t_max=t_max, exclude=exclude,
                                live=live, any_hit=any_hit,
                                block_rays=block_rays, block_tris=block_tris,
                                interpret=interpret)

    return intersect_fn
