"""Exact one-pass row fetch: ``out[r] = table[idx[r]]`` as a matmul.

The tracer gathers a fused per-triangle payload row for every hit
(:class:`hermespy_rt_tpu.tracer.LocalSceneAccess`).  Expressing the gather as
``one_hot(idx) @ table`` makes its backward — a scatter-add into the table —
a matmul too, but an exact float32 product would need full-precision passes.

The trick: a one-hot matrix is *exactly* representable in bf16, and a f32
table splits exactly into three bf16 limbs (8 mantissa bits each).  Stacking
the limbs along the column axis (``[T, C] -> [T, 3C]`` bf16) makes ONE
native-bf16 pass with float32 accumulation compute every limb of the selected
row exactly (each output element is a single ``1.0 * limb`` product); summing
the three limb groups reconstructs the f32 row bit-exactly.  On a GPU the
pass runs on the tensor cores.

The backward applies the identical trick to the cotangent: ``dtable =
one_hot(idx)^T @ split3(g)`` — also one pass, exact up to the float32
accumulation order of the rays that hit the same triangle.  ``idx`` is a
non-differentiable decision input (hit indices).

Reference context: the gather replaces the reference's per-hit struct reads
(``scene->meshes[mesh_ind]`` fields, /root/reference/src/compute_paths.c:621,
:653, :661) with one dense lookup.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["onehot_fetch", "take_fetch"]


def _split3_bf16(x):
    """f32 -> 3 bf16 limbs with h1 + h2 + h3 == x exactly (24 = 3 x 8
    mantissa bits).

    The optimization barriers are load-bearing: under XLA's default
    ``--xla_allow_excess_precision=true`` the compiler may elide
    ``convert_f32(convert_bf16(x))`` round-trips — turning ``x - f32(bf16(x))``
    into ``x - x == 0`` and silently zeroing the lower limbs (a 2^-8
    relative fetch error).  The barrier pins the rounded value so the
    residual is computed for real.
    """
    h1 = x.astype(jnp.bfloat16)
    r1 = x - jax.lax.optimization_barrier(h1).astype(jnp.float32)
    h2 = r1.astype(jnp.bfloat16)
    h3 = (r1 - jax.lax.optimization_barrier(h2).astype(jnp.float32)
          ).astype(jnp.bfloat16)
    return h1, h2, h3


def _limb_cols(x):
    """[..., C] f32 -> [..., 3C] bf16 (limb groups stacked along columns)."""
    return jnp.concatenate(_split3_bf16(x), axis=-1)


def _sum_limb_cols(y, c):
    """[..., 3C] f32 -> [..., C]: exact f32 reconstruction."""
    return y[..., :c] + y[..., c:2 * c] + y[..., 2 * c:]


def _onehot_bf16(idx, t):
    """bf16 one-hot rows for already-clamped indices (exact: 0/1)."""
    iota = jax.lax.broadcasted_iota(jnp.int32, idx.shape + (t,), idx.ndim)
    return (idx[..., None] == iota).astype(jnp.bfloat16)


@jax.custom_vjp
def onehot_fetch(idx, table):
    """``table[idx]`` for clamped ``idx`` i32[...], ``table`` f32[T, C],
    computed as one exact native-bf16 matmul.  Differentiable w.r.t.
    ``table``."""
    out, _ = _onehot_fetch_fwd(idx, table)
    return out


def _onehot_fetch_fwd(idx, table):
    t, c = table.shape
    oh = _onehot_bf16(jax.lax.stop_gradient(idx), t)
    y = jnp.dot(oh, _limb_cols(table), preferred_element_type=jnp.float32)
    return _sum_limb_cols(y, c), (idx, t, c)


def _onehot_fetch_bwd(res, g):
    idx, t, c = res
    oh = _onehot_bf16(idx, t)                       # [..., T]
    oh2 = oh.reshape(-1, t)                          # [R, T]
    g2 = g.reshape(-1, c)                            # [R, C]
    dy = jnp.dot(oh2.T, _limb_cols(g2),
                 preferred_element_type=jnp.float32)  # [T, 3C]
    return None, _sum_limb_cols(dy, c)


onehot_fetch.defvjp(_onehot_fetch_fwd, _onehot_fetch_bwd)


def take_fetch(idx, table):
    """``table[idx]`` as a plain XLA gather (wins for large tables where the
    one-hot operand would dominate)."""
    return jnp.take(table, idx, axis=0)
