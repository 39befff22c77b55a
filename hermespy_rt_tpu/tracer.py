"""The differentiable multipath tracer: LoS pass + specular-bounce/scatter loop.

Capability parity with the reference compute engine
(``/root/reference/src/compute_paths.c:419-757``): Fibonacci-sphere ray launch
per TX, a LoS occlusion pass per (RX, TX) pair with Friis amplitude and
Doppler, then ``num_bounces`` rounds of nearest-hit intersection, ITU Fresnel
reflection with per-segment free-space loss, specular ray update with a 1e-4
self-hit offset, mesh-velocity Doppler accumulation, and a scatter-to-RX
shadow-ray pass with directive scattering coefficients.  Outputs mirror the
reference ``ChannelInfo``/``RaysInfo`` schema
(/root/reference/inc/compute_paths.h:13-30).

Array-first redesign (not a port):

* All per-ray state is dense f32 arrays over a flattened ``(tx * path)`` axis;
  activity is a boolean mask, not a bitmask walk.
* The bounce loop is a ``lax.scan`` (optionally unrolled) whose carry is the
  ray state; each step issues exactly two batched nearest-hit queries (bounce
  rays, then ``num_rx`` shadow rays batched together).
* Hit indices are non-differentiable decisions (``stop_gradient``); every
  differentiable quantity (hit distance, normal, material row) is re-derived
  by gathering the chosen triangle, so ``jax.grad`` flows to material
  parameters, TX/RX positions/velocities and scene vertices without custom
  VJPs around the argmin.
* Scene access is abstracted behind :class:`SceneAccess` so the same bounce
  code runs with a replicated scene (gathers) or a triangle-sharded scene
  (local argmin + cross-device min-reduction + masked-psum payload fetch,
  see :mod:`hermespy_rt_tpu.parallel.sharding`).
* Known reference defects are NOT reproduced (SURVEY.md §3.5): Doppler uses a
  single well-defined accumulation semantics laid out as
  ``(rx, tx, bounce, path)``; deactivated/blocked output slots are zeroed
  instead of leaking uninitialised memory; scatter ``directions_tx`` is
  populated with the launch direction.  The observable quirks needed for
  golden tests are kept behind ``TracerConfig.parity == "reference"``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from jax.ad_checkpoint import checkpoint_name

from .config import TracerConfig
from .materials import MaterialTable
from .ops.fresnel import EtaPrecomputed, precompute_eta
from .ops.geometry import cross3, dot3, fast_acos, fibonacci_sphere
from .ops.intersect import FLT_EPS, intersect_jnp
from .ops.scattering import scat_coefs
from .ops.shade import shade_a_jnp
from .scene.model import TriangleSoA

__all__ = ["ChannelInfo", "RaysInfo", "PathsResult", "trace_paths",
           "LocalSceneAccess", "SPEED_OF_LIGHT", "PI"]

SPEED_OF_LIGHT = np.float32(299792458.0)  # m/s (compute_paths.c:19)
PI = np.float32(3.14159265358979323846)
_CLIP = np.float32(1.0) - np.float32(FLT_EPS)  # grad-safe acos clamp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChannelInfo:
    """Per-path channel parameters, shaped like the reference pybind views
    (/root/reference/compute_paths_pybind11.cpp:54-96): ``num_rays`` is 1 for
    LoS and ``num_bounces * num_paths`` for scatter, ordered bounce-major."""

    directions_rx: jax.Array  # f32[NRx, NTx, K, 3]
    directions_tx: jax.Array  # f32[NRx, NTx, K, 3]
    a_te: jax.Array           # complex64[NRx, NTx, K]
    a_tm: jax.Array           # complex64[NRx, NTx, K]
    tau: jax.Array            # f32[NRx, NTx, K]  (seconds)
    freq_shift: jax.Array     # f32[NRx, NTx, K]  (Hz)

    @property
    def num_rays(self) -> int:
        return self.tau.shape[-1]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RaysInfo:
    """Ray segments per bounce (reference RaysInfo,
    /root/reference/inc/compute_paths.h:26-30, with a sane dense layout):
    slot 0 holds the launch rays, slot ``b+1`` the state after bounce ``b``."""

    origins: jax.Array     # f32[NTx, B+1, P, 3]
    directions: jax.Array  # f32[NTx, B+1, P, 3]
    active: jax.Array      # bool[NTx, B+1, P]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PathsResult:
    los: ChannelInfo
    scatter: ChannelInfo
    rays_los: Optional[RaysInfo] = None
    rays_scatter: Optional[RaysInfo] = None
    # occlusion decision of the LoS pass, bool[NRx, NTx]: True when a scene
    # triangle blocks the direct segment.  Carried explicitly because the
    # amplitude no longer encodes it under transmission=True (a blocked LoS
    # then has nonzero penetration-loss gain) — consumers must not infer
    # blockage from |a_te| == 0.
    los_blocked: Optional[jax.Array] = None


# columns of the fused per-triangle payload table, after the 15 geometry
# columns v0(0:3) e1(3:6) e2(6:9) normal(9:12) velocity(12:15)
_ETA_FIELDS = ("eta_re", "eta_im", "eta_abs", "eta_abs_pow2",
               "eta_abs_inv_sqrt", "eta_sqrt_re", "eta_sqrt_im", "eta_inv_re",
               "eta_inv_im", "r", "s", "s1_alpha")
_GEOM_COLS = 15


class LocalSceneAccess:
    """Scene access with the full (replicated) triangle SoA on this device.

    The per-hit payload (triangle basis, normal, velocity, material eta row)
    lives in ONE fused ``[T, 27]`` table so a hit fetch is a single lookup
    instead of 18 small-table gathers.  ``gather`` picks how the lookup is
    made (see :attr:`TracerConfig.gather`): a plain XLA gather ("take") or an
    exact one-hot matmul ("onehot", :mod:`hermespy_rt_tpu.ops.fetch`), whose
    backward scatter-add is a matmul too.
    """

    def __init__(self, tris: TriangleSoA, intersect_fn=None,
                 cfg: Optional[TracerConfig] = None,
                 eta: Optional[EtaPrecomputed] = None):
        cfg = cfg or TracerConfig()
        self.tris = tris
        if intersect_fn is None:
            intersect_fn = _select_intersect(tris, cfg)
        self._intersect = intersect_fn
        # user-supplied intersect_fns may predate the any-hit declaration;
        # nearest-hit is always a valid any-hit answer, so just drop it
        import inspect
        try:
            self._any_hit_ok = ("any_hit"
                                in inspect.signature(intersect_fn).parameters)
        except (TypeError, ValueError):
            self._any_hit_ok = False
        self._gather = cfg.gather
        self._grad_geometry = cfg.grad_geometry
        self._table = None
        self._eta_tab = None
        if eta is not None:
            mat = tris.material
            eta_cols = jnp.stack([getattr(eta, f)[mat] for f in _ETA_FIELDS],
                                 axis=-1)                       # [T, 12]
            self._table = jnp.concatenate(
                [tris.v0, tris.e1, tris.e2, tris.normal, tris.velocity,
                 eta_cols], axis=-1)                            # [T, 27]
            self._eta_tab = jnp.stack(
                [getattr(eta, f) for f in _ETA_FIELDS], axis=-1)  # [M, 12]

    def intersect(self, o, d, t_max=None, exclude=None, live=None,
                  any_hit=False):
        """Nearest hit: (t f32[R] (+inf miss), idx i32[R] (-1 miss)).

        ``any_hit=True`` declares that the caller only consumes the
        *existence* of a hit with ``t <= t_max`` (occlusion tests) — a
        valid implementation may return ANY qualifying hit, which lets the
        intersection kernel stop a ray block once every ray has a blocker
        instead of scanning to the nearest (the reference has no such fast
        path; its shadow rays run the full nearest scan,
        /root/reference/src/compute_paths.c:666-683).

        ``t_max`` restricts the query to hits with ``t <= t_max`` (a
        performance hint for range-limited occlusion tests; hits beyond it
        report as misses).  ``exclude`` (i32[R]) suppresses one triangle per
        ray — the one the ray provably originates on, so the kernel never
        evaluates epsilon-scale self-hit geometry (-1 = none).  ``live``
        (bool[R]) marks rays whose result will actually be consumed: results
        for dead rays are unspecified (the kernel skips ray blocks with no
        live ray — the array form of the reference's active-bitmask walk,
        reference src/compute_paths.c:596-605).

        Hit decisions are non-differentiable by design (piecewise constant):
        gradients are cut here, which also spares the O(rays x triangles)
        backward sweep — the tracer re-derives differentiable hit quantities
        from the gathered triangle instead.
        """
        o = jax.lax.stop_gradient(o)
        d = jax.lax.stop_gradient(d)
        if not self._any_hit_ok:
            return self._intersect(o, d, t_max, exclude, live)
        return self._intersect(o, d, t_max, exclude, live, any_hit=any_hit)

    def _rows(self, idx_safe):
        """Table rows for clamped indices, any leading shape -> [..., 27]."""
        if self._gather == "take":
            return self._table[idx_safe]
        from .ops.fetch import onehot_fetch
        row = onehot_fetch(idx_safe, self._table)
        return checkpoint_name(row, "payload")

    def fetch(self, idx_safe) -> Dict[str, jax.Array]:
        """Per-hit triangle payload for already-clamped indices.

        With ``cfg.grad_geometry=False`` the geometry columns come back
        behind ``stop_gradient`` — material gradients are unchanged (the
        eta chain never passes through geometry) and XLA DCE drops the
        cross-bounce geometric backward (see TracerConfig.grad_geometry).
        """
        if self._gather == "take" and self._eta_tab is not None:
            # Take fetch: geometry columns stay a plain XLA gather —
            # with grad_geometry=False they are stop-gradded, so NO backward
            # scatter into the [T, 27] table exists at all — and the eta
            # columns are fetched INDIRECTLY through the per-material table
            # (eta[mat][tri_idx] == eta[mat[tri_idx]] bit-exactly).  The
            # differentiable part of the fetch thus contracts over the
            # ~17 material rows, and its backward is an exact one-hot
            # scatter-add into [M, 12] instead of a scatter into the
            # triangle table.
            geo_rows = self._table[:, :_GEOM_COLS][idx_safe]
            geo = (geo_rows if self._grad_geometry
                   else jax.lax.stop_gradient(geo_rows))
            mat_idx = jax.lax.stop_gradient(self.tris.material[idx_safe])
            from .ops.fetch import onehot_fetch
            eta_rows = onehot_fetch(mat_idx, self._eta_tab)
            out = dict(v0=geo[..., 0:3], e1=geo[..., 3:6], e2=geo[..., 6:9],
                       normal=geo[..., 9:12], velocity=geo[..., 12:15])
            out["eta"] = EtaPrecomputed(**{
                f: eta_rows[..., i] for i, f in enumerate(_ETA_FIELDS)})
            return out
        return self.split_rows(self._rows(idx_safe))

    def split_rows(self, row) -> Dict[str, jax.Array]:
        """[..., 27] fused payload rows -> the fetch dict (geometry behind
        ``stop_gradient`` unless ``cfg.grad_geometry``)."""
        geo = row if self._grad_geometry else jax.lax.stop_gradient(row)
        out = dict(v0=geo[..., 0:3], e1=geo[..., 3:6], e2=geo[..., 6:9],
                   normal=geo[..., 9:12], velocity=geo[..., 12:15])
        out["eta"] = EtaPrecomputed(**{
            f: row[..., _GEOM_COLS + i] for i, f in enumerate(_ETA_FIELDS)})
        return out

    def normal_at(self, idx_safe):
        if self._table is not None:
            n = self._rows(idx_safe)[..., 9:12]
            return n if self._grad_geometry else jax.lax.stop_gradient(n)
        return self.tris.normal[idx_safe]


def resolve_backend(cfg: TracerConfig) -> str:
    """The device policy: which intersection implementation a trace uses.

    ``backend="jnp"`` is plain JAX and runs anywhere.  Otherwise the
    platform JAX compiles for decides: a GPU runs the Pallas (Triton)
    kernel, a CPU runs jnp under ``"auto"`` and refuses ``"pallas"`` (the
    kernel runs there only in interpret mode, which tests request through
    ``make_pallas_intersect(..., interpret=True)``), and any other platform
    is an error."""
    if cfg.backend == "jnp":
        return "jnp"
    platform = jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        if cfg.backend == "pallas":
            raise RuntimeError("backend='pallas' needs a GPU; this process "
                               "compiles for the CPU (use 'auto' or 'jnp')")
        return "jnp"
    raise RuntimeError(f"no intersection backend for platform {platform!r}"
                       " (supported: gpu, cpu)")


def _select_intersect(tris: TriangleSoA, cfg: TracerConfig):
    if resolve_backend(cfg) == "pallas":
        from .ops.intersect_pallas import make_pallas_intersect
        return make_pallas_intersect(tris)

    def jnp_fn(o, d, t_max=None, exclude=None, live=None, any_hit=False):
        # the jnp path ignores the liveness hint (dead results are masked by
        # the tracer anyway) and the any-hit declaration (nearest is a valid
        # any-hit answer); kernel-vs-jnp comparisons must mask by `live`
        t, idx = intersect_jnp(o, d, tris, chunk_size=cfg.ray_chunk,
                               exclude=exclude)
        if t_max is not None:
            within = t <= jax.lax.stop_gradient(jnp.asarray(t_max, t.dtype))
            t = jnp.where(within, t, jnp.inf)
            idx = jnp.where(within, idx, -1)
        return t, idx

    return jnp_fn


def _shadow_intersect(access, so, ds, t_max, excl, cfg: TracerConfig,
                      live=None, any_hit=False):
    """Shadow-ray nearest-hit over the flattened [NRx * R] axis, chunked over
    RX groups so the query operands stay bounded at large NRx.

    ``so``/``ds`` are [NRx, R, 3]; ``t_max``/``excl`` flat [NRx * R] (or
    None).  A single batched query is fastest, but its operands and the jnp
    path's [chunk, T] intermediates scale with NRx * R (the reference never
    hits this because it walks rays one at a time,
    reference src/compute_paths.c:666-723).  Groups are
    the largest divisor of NRx keeping each query under ``cfg.rx_query_rays``
    rays; the per-group queries run sequentially under ``lax.map``.
    """
    nrx, R = so.shape[0], so.shape[1]
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    c = max(1, cfg.rx_query_rays // R)          # rx rows per query
    while nrx % c:
        c -= 1
    if c >= nrx:
        return access.intersect(flat(so), flat(ds), t_max=t_max,
                                exclude=excl, live=live, any_hit=any_hit)
    G = nrx // c
    grp = lambda x: None if x is None else x.reshape((G, -1))
    tm_g, ex_g, lv_g = grp(t_max), grp(excl), grp(live)
    xs = (so.reshape(G, c * R, 3), ds.reshape(G, c * R, 3)) \
        + tuple(x for x in (tm_g, ex_g, lv_g) if x is not None)

    def one(args):
        so_i, ds_i, rest = args[0], args[1], list(args[2:])
        tm_i = rest.pop(0) if tm_g is not None else None
        ex_i = rest.pop(0) if ex_g is not None else None
        lv_i = rest.pop(0) if lv_g is not None else None
        return access.intersect(so_i, ds_i, t_max=tm_i, exclude=ex_i,
                                live=lv_i, any_hit=any_hit)

    t_o, idx_o = jax.lax.map(one, xs)
    return t_o.reshape(-1), idx_o.reshape(-1)


def _safe_norm(v):
    n2 = dot3(v, v)
    n = jnp.sqrt(jnp.where(n2 > 0, n2, 1.0))
    return jnp.where(n2 > 0, n, 0.0)


def _recompute_t(o, d, hit, live):
    """Differentiable hit distance from the gathered triangle
    (t = (e2 . (s x e1)) / (e1 . (d x e2)), masked to 0 off-hit)."""
    pvec = cross3(d, hit["e2"])
    det = dot3(hit["e1"], pvec)
    qvec = cross3(o - hit["v0"], hit["e1"])
    inv_det = 1.0 / jnp.where(det == 0, 1.0, det)
    t = dot3(hit["e2"], qvec) * inv_det
    return jnp.where(live, t, 0.0)


def _los_pass(access: LocalSceneAccess, rx_pos, tx_pos, rx_vel, tx_vel, fslm,
              k_dop, cfg):
    """LoS occlusion pass per (rx, tx) pair
    (/root/reference/src/compute_paths.c:510-577)."""
    nrx, ntx = rx_pos.shape[0], tx_pos.shape[0]
    o = jnp.broadcast_to(tx_pos[None, :, :], (nrx, ntx, 3)).reshape(-1, 3)
    dvec = (rx_pos[:, None, :] - tx_pos[None, :, :]).reshape(-1, 3)

    d2 = dot3(dvec, dvec)
    coincident = d2 < FLT_EPS

    # occlusion only (t in units of |d|); range-limit as a perf hint
    t_hit, idx = access.intersect(o, dvec, t_max=1.0)
    blocked = (idx >= 0) & (t_hit <= 1.0) & ~coincident

    dist = jnp.sqrt(jnp.where(coincident, 1.0, d2))
    dn = dvec / jnp.where(coincident, 1.0, dist)[:, None]

    fsl = fslm * dist
    amp = jnp.where(fsl > 1.0, 1.0 / jnp.where(fsl > 1.0, fsl, 1.0), 1.0)
    if cfg.transmission:
        # occlusion with penetration loss: attenuate blocked LoS paths by the
        # nearest blocker's ITU transmission coefficients (eqs. 31c/31d)
        from .ops.fresnel import trans_coefs
        hit_b = access.fetch(jnp.maximum(idx, 0))
        cos1 = jnp.clip(jnp.abs(dot3(hit_b["normal"], dn)), 0.0, _CLIP)
        sin1 = jnp.sqrt(1.0 - cos1 * cos1)
        tte_re, tte_im, ttm_re, ttm_im = trans_coefs(hit_b["eta"], cos1, sin1)
        bf = blocked.astype(jnp.float32)
        te_re = jnp.where(coincident, 1.0, amp * (1.0 + bf * (tte_re - 1.0)))
        te_im = jnp.where(coincident, 0.0, amp * bf * tte_im)
        tm_re = jnp.where(coincident, 1.0, amp * (1.0 + bf * (ttm_re - 1.0)))
        tm_im = jnp.where(coincident, 0.0, amp * bf * ttm_im)
        tau = jnp.where(coincident, 0.0, dist / SPEED_OF_LIGHT)
    else:
        a_re = jnp.where(coincident, 1.0, jnp.where(blocked, 0.0, amp))
        te_re = tm_re = a_re
        te_im = tm_im = jnp.zeros_like(a_re)
        tau = jnp.where(coincident | blocked, 0.0, dist / SPEED_OF_LIGHT)

    if cfg.parity == "reference":
        # Reference bug kept for parity: velocity row 0 for every pair
        # (/root/reference/src/compute_paths.c:573).
        txv = jnp.broadcast_to(tx_vel[0][None, None], (nrx, ntx, 3)).reshape(-1, 3)
        rxv = jnp.broadcast_to(rx_vel[0][None, None], (nrx, ntx, 3)).reshape(-1, 3)
    else:
        txv = jnp.broadcast_to(tx_vel[None, :, :], (nrx, ntx, 3)).reshape(-1, 3)
        rxv = jnp.broadcast_to(rx_vel[:, None, :], (nrx, ntx, 3)).reshape(-1, 3)
    freq = (dot3(txv, dn) - dot3(rxv, dn)) * k_dop
    if cfg.transmission:
        freq = jnp.where(coincident, 0.0, freq)
    else:
        freq = jnp.where(coincident | blocked, 0.0, freq)

    x_hat = jnp.array([1.0, 0.0, 0.0], jnp.float32)
    dir_tx = jnp.where(coincident[:, None], x_hat[None, :], dn)
    dir_rx = jnp.where(coincident[:, None], -x_hat[None, :], -dn)

    los = ChannelInfo(
        directions_rx=dir_rx.reshape(nrx, ntx, 1, 3),
        directions_tx=dir_tx.reshape(nrx, ntx, 1, 3),
        a_te=(te_re + 1j * te_im).astype(jnp.complex64).reshape(nrx, ntx, 1),
        a_tm=(tm_re + 1j * tm_im).astype(jnp.complex64).reshape(nrx, ntx, 1),
        tau=tau.reshape(nrx, ntx, 1),
        freq_shift=freq.reshape(nrx, ntx, 1),
    )
    rays = RaysInfo(
        origins=o.reshape(nrx, ntx, 1, 3).transpose(1, 2, 0, 3),
        directions=dvec.reshape(nrx, ntx, 1, 3).transpose(1, 2, 0, 3),
        active=(~blocked).reshape(nrx, ntx, 1).transpose(1, 2, 0),
    ) if cfg.keep_rays else None
    return los, rays, blocked.reshape(nrx, ntx)


def bounce_step(carry, _, *, access, rx_pos, fslm, k_dop,
                cfg: TracerConfig):
    """One bounce: reflect every active ray off its nearest triangle, then
    scatter a shadow ray from the hit point to every RX
    (reference src/compute_paths.c:591-745)."""
    (o, d, ate_re, ate_im, atm_re, atm_im, tau, act, freq, pat,
     pidx) = carry
    nrx = rx_pos.shape[0]
    # transmission spawning: bit 0 of the per-ray pattern selects "pass
    # straight through with the ITU transmission coefficients" for THIS
    # bounce; the pattern is consumed one bit per bounce.
    transmit = ((pat & 1) != 0) if cfg.spawn_transmission else None

    # --- nearest hit (non-differentiable decision) ---
    # Dead-ray skipping (cfg.compact_rays): the activity mask rides into the
    # kernel, which skips ray blocks with no live ray.  No reordering is needed: rays
    # die in contiguous index bands (the Fibonacci launch index is
    # sequential in polar angle, so scene-missing directions cluster), and a
    # forced miss for a dead ray is semantically identical to ignoring its
    # result.
    # The triangle this ray originates on (its previous hit) is excluded
    # in-kernel: a reflected or straight-transmitted ray, offset off its
    # plane, provably cannot re-cross that plane, so any kernel self-hit is
    # pure rounding noise.  This removes all epsilon-scale geometry from the
    # query.
    if cfg.compact_rays:
        _, idx = access.intersect(o, d, exclude=pidx, live=act)
    else:
        _, idx = access.intersect(o, d, exclude=pidx)
    idx = jax.lax.stop_gradient(idx)
    # named residual: under cfg.remat="hits" the bounce checkpoint saves
    # exactly the kernel decisions + payload rows, so the backward never
    # re-runs an intersection while all elementwise shading recomputes
    idx = checkpoint_name(idx, "hit")
    live = act & (idx >= 0)
    safe = jnp.maximum(idx, 0)

    # --- differentiable hit quantities via gather + shading ---
    # (hit-distance recompute, folded incidence trig, ITU Fresnel with
    # per-segment free-space loss, complex amplitude update, specular ray
    # update with the 1e-4 self-hit offset, mesh-velocity Doppler —
    # compute_paths.c:607-664; one elementwise chain XLA fuses.)
    hit = access.fetch(safe)
    mat_rows = hit["eta"]
    (o, d, ate_re, ate_im, atm_re, atm_im, tau, freq, theta, cos_t1,
     ndot) = shade_a_jnp(o, d, ate_re, ate_im, atm_re, atm_im, tau, freq,
                         live, {k: hit[k] for k in ("v0", "e1", "e2",
                                                    "normal", "velocity")},
                         mat_rows, fslm, k_dop, transmit=transmit,
                         refraction=cfg.refraction)
    n = hit["normal"]
    vel = hit["velocity"]

    s_row, s1_row = mat_rows.s, mat_rows.s1_alpha

    # --- scatter-to-RX shadow rays, all RX batched into one query ---
    so = jnp.broadcast_to(o[None], (nrx,) + o.shape)          # [NRx, R, 3]
    ds_un = rx_pos[:, None, :] - so                           # [NRx, R, 3]
    d2rx = _safe_norm(ds_un)                                  # [NRx, R]
    ds = ds_un / jnp.where(d2rx > 0, d2rx, 1.0)[..., None]

    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    live_b = jnp.broadcast_to(live[None], d2rx.shape)   # post-hit liveness
    ds_dot_n = dot3(ds, n[None])                        # [NRx, R]

    # The shadow ray's own triangle is excluded from the kernel query too;
    # whether it crosses its own plane (RX on the far side) is decided
    # analytically instead, in exact local arithmetic: the origin sits at
    # signed offset 1e-4*(d_int.n) off the plane, so it crosses at
    # t0 = -1e-4*(d_int.n)/(ds.n).  This is the reference's own nearest
    # blocker whenever it exists (~1e-4 away beats everything else).
    dint_n = dot3(d, n)                                 # post-interaction
    t_self = -jnp.float32(1e-4) * dint_n[None, :] / jnp.where(
        ds_dot_n == 0.0, 1.0, ds_dot_n)
    crossing = (ds_dot_n * dint_n[None, :] < 0.0) & live_b
    excl = flat(jnp.broadcast_to(jnp.where(live, idx, -1)[None],
                                 live_b.shape))
    if cfg.parity == "reference":
        # Reference quirk kept for parity: with a *normalised* direction the
        # occlusion test still uses t <= 1, i.e. only blockers within 1 metre
        # count (/root/reference/src/compute_paths.c:678-683).
        lv = flat(live_b) if cfg.compact_rays else None
        t_o, idx_o = checkpoint_name(
            _shadow_intersect(access, so, ds, None, excl, cfg, live=lv),
            "hit")
        self_hit = flat(crossing & (t_self > jnp.float32(FLT_EPS)))
        closer = self_hit & (flat(t_self) < t_o)
        t_o = jnp.where(closer, flat(t_self), t_o)
        idx_o = jnp.where(closer, excl, idx_o)
        blocked = (idx_o >= 0) & (t_o <= 1.0)
    else:
        eps_o = jnp.float32(cfg.occlusion_offset)
        limit = flat(d2rx) - 2.0 * eps_o
        lv = flat(live_b) if cfg.compact_rays else None
        # physical mode consumes only `blocked` (any qualifying hit) from
        # this query — unless transmission needs the nearest blocker's eta
        # — so the kernel may stop a ray block once every ray has an
        # in-range hit (any-hit early-out; bit-identical `blocked`)
        t_o, idx_o = checkpoint_name(
            _shadow_intersect(access, so + eps_o * ds, ds, limit, excl,
                              cfg, live=lv,
                              any_hit=(cfg.shadow_any_hit
                                       and not cfg.transmission)), "hit")
        # in query coordinates the origin is a further eps_o along ds
        t_self_q = flat(t_self) - eps_o
        self_hit = (flat(crossing) & (t_self_q > jnp.float32(FLT_EPS))
                    & (t_self_q <= limit))
        closer = self_hit & (t_self_q < t_o)
        t_o = jnp.where(closer, t_self_q, t_o)
        idx_o = jnp.where(closer, excl, idx_o)
        blocked = (idx_o >= 0) & (t_o <= limit)
    blocked = blocked.reshape(nrx, -1)

    cos_ts = jnp.clip(ds_dot_n, -_CLIP, _CLIP)
    theta_s = fast_acos(cos_ts)                               # no fold (c:694)

    # Hemisphere consistency (physical mode only): a reflection interaction
    # re-radiates into the incidence-side hemisphere, a transmission
    # interaction into the exit-side one.  The reference gets the same
    # outcome implicitly — its shadow ray starts ~1e-4 off the surface and
    # the surface itself blocks back-face scatter within the 1-metre window
    # — but the physical mode's occlusion offset (which exists to avoid
    # self-hits) would hop the shadow ray across its own surface.
    hemi = None
    if cfg.parity != "reference":
        hemi = ds_dot_n * ndot[None] < 0.0
        if cfg.spawn_transmission:
            hemi = jnp.where(transmit[None],
                             ds_dot_n * ndot[None] > 0.0, hemi)

    if cfg.parity == "reference":
        # Deep reference quirk: the shadow-ray moeller_trumbore call writes
        # its hit angle into the *same* ``theta`` variable that is then passed
        # to scat_coefs as the incidence angle
        # (/root/reference/src/compute_paths.c:682 reuses &theta from :615).
        # Any shadow hit — at any distance, blocked or not — clobbers it, and
        # the clobber persists into subsequent rx iterations.  Reproduce the
        # chain: th_used[rx] = shadow-hit angle of rx if it hit, else the
        # previous rx's value, seeded with the bounce incidence angle.
        idx_o2 = jax.lax.stop_gradient(idx_o).reshape(nrx, -1)
        occl_hit = idx_o2 >= 0
        n_o = access.normal_at(jnp.maximum(idx_o2, 0))        # [NRx, R, 3]
        cos_o = jnp.clip(jnp.abs(dot3(n_o, ds)), 0.0, _CLIP)  # MT folds (c:282)
        th_o = fast_acos(cos_o)
        th_c, cos_c = theta, cos_t1
        th_used, cos_used = [], []
        for k in range(nrx):
            th_c = jnp.where(occl_hit[k], th_o[k], th_c)
            cos_c = jnp.where(occl_hit[k], cos_o[k], cos_c)
            th_used.append(th_c)
            cos_used.append(cos_c)
        theta_i_scat = jnp.stack(th_used)                     # [NRx, R]
        cos_ti = jnp.stack(cos_used)
    else:
        theta_i_scat = jnp.broadcast_to(theta[None], theta_s.shape)
        cos_ti = jnp.broadcast_to(cos_t1[None], theta_s.shape)
    sin_ti = jnp.sqrt(1.0 - cos_ti * cos_ti)

    s_te_re, s_te_im, s_tm_re, s_tm_im = scat_coefs(
        theta_s, theta_i_scat, s_row[None], s1_row[None],
        cos_ts=cos_ts, cos_ti=cos_ti, sin_ti=sin_ti)

    out_te_re = ate_re[None] * s_te_re - ate_im[None] * s_te_im
    out_te_im = ate_re[None] * s_te_im + ate_im[None] * s_te_re
    out_tm_re = atm_re[None] * s_tm_re - atm_im[None] * s_tm_im
    out_tm_im = atm_re[None] * s_tm_im + atm_im[None] * s_tm_re

    fsl_s2 = (fslm * d2rx) ** 2
    sscale = jnp.where(fsl_s2 > 1.0, 1.0 / jnp.where(fsl_s2 > 1.0, fsl_s2, 1.0), 1.0)
    if cfg.transmission:
        # blocked shadow rays transmit through the nearest blocker with the
        # ITU (31c)/(31d) coefficients instead of being zeroed
        from .ops.fresnel import trans_coefs
        hit_o = access.fetch(
            jax.lax.stop_gradient(jnp.maximum(idx_o, 0)).reshape(nrx, -1))
        cos1b = jnp.clip(jnp.abs(dot3(hit_o["normal"], ds)), 0.0, _CLIP)
        sin1b = jnp.sqrt(1.0 - cos1b * cos1b)
        tte_re, tte_im, ttm_re, ttm_im = trans_coefs(hit_o["eta"], cos1b,
                                                     sin1b)
        bf = blocked.astype(jnp.float32)
        fte_re = 1.0 + bf * (tte_re - 1.0)
        fte_im = bf * tte_im
        ftm_re = 1.0 + bf * (ttm_re - 1.0)
        ftm_im = bf * ttm_im
        out_te_re, out_te_im = (out_te_re * fte_re - out_te_im * fte_im,
                                out_te_re * fte_im + out_te_im * fte_re)
        out_tm_re, out_tm_im = (out_tm_re * ftm_re - out_tm_im * ftm_im,
                                out_tm_re * ftm_im + out_tm_im * ftm_re)
        write = jnp.broadcast_to(live[None], blocked.shape)
    else:
        write = live[None] & ~blocked
    if hemi is not None:
        write = write & hemi
    wf = write.astype(jnp.float32) * sscale

    out_te_re, out_te_im = out_te_re * wf, out_te_im * wf
    out_tm_re, out_tm_im = out_tm_re * wf, out_tm_im * wf
    out_tau = jnp.where(write, tau[None] + d2rx / SPEED_OF_LIGHT, 0.0)
    # Doppler of the scattered leg (compute_paths.c:719-722), well-defined
    # (rx, tx, bounce, path) layout instead of the reference's aliased
    # buffers; rays that died earlier keep their accumulated value (their
    # gathered triangle payload is a clamped-index placeholder).
    scat_dop = dot3(ds - d[None], vel[None]) * k_dop
    out_freq = freq[None] - jnp.where(live[None], scat_dop, 0.0)
    out_dir_rx = jnp.where(write[..., None], -ds, 0.0)

    carry = (o, d, ate_re, ate_im, atm_re, atm_im, tau, live, freq,
             pat >> 1, jnp.where(live, idx, -1))
    # rays/active outputs are only consumed for RaysInfo: emit nothing when
    # keep_rays is off (None = empty pytree node — the scan stacks nothing,
    # saving the [B, R, 3] x2 + [B, R] per-trace HBM materialisations)
    ys = (out_te_re, out_te_im, out_tm_re, out_tm_im, out_tau, out_freq,
          out_dir_rx) + ((o, d, live) if cfg.keep_rays
                         else (None, None, None))
    return carry, ys


def launch_state(tx_pos, tx_vel, launch_dirs, k_dop, active0=None,
                 transmit_pattern=None):
    """Initial per-ray state over the flattened tx-major ray axis
    (/root/reference/src/compute_paths.c:442-508).

    ``transmit_pattern`` (i32[R], optional) is the per-ray interaction
    bit-pattern for transmission-path spawning: bit ``b`` set means the ray
    passes straight through the surface it hits at bounce ``b`` (with the
    ITU eq. 31c/31d transmission coefficients) instead of reflecting.  The
    pattern rides in the carry and is right-shifted once per bounce, so it
    shards with the ray axis and needs no bounce counter.
    """
    ntx = tx_pos.shape[0]
    P = launch_dirs.shape[0]
    d0 = jnp.tile(launch_dirs, (ntx, 1))                       # [R, 3]
    o0 = jnp.repeat(tx_pos, P, axis=0)                         # [R, 3]
    txv0 = jnp.repeat(tx_vel, P, axis=0)
    R = ntx * P
    ones = jnp.ones((R,), jnp.float32)
    zeros = jnp.zeros((R,), jnp.float32)
    freq0 = dot3(txv0, d0) * k_dop
    act = jnp.ones((R,), bool) if active0 is None else active0
    pat = (jnp.zeros((R,), jnp.int32) if transmit_pattern is None
           else jnp.asarray(transmit_pattern, jnp.int32))
    pidx0 = jnp.full((R,), -1, jnp.int32)   # no originating triangle yet
    return (o0, d0, ones, zeros, ones, zeros, zeros, act, freq0, pat, pidx0)


def transmit_patterns(num_rays: int, num_bounces: int) -> jax.Array:
    """Uniform interaction-pattern assignment for transmission spawning:
    ray ``i`` follows bit pattern ``i mod 2**B`` (bit b = transmit at bounce
    b).  All 2**B reflect/transmit sequences of the interaction tree are
    sampled with equal ray budget and static shapes — the array-first
    realisation of the reference's unimplemented refraction branch
    (/root/reference/src/compute_paths.c:725-728): no dynamic ray spawning,
    the tree is covered by partitioning the launch set.  Interleaving by ray
    index spreads every pattern uniformly over the Fibonacci sphere."""
    return jnp.arange(num_rays, dtype=jnp.int32) % jnp.int32(2 ** num_bounces)


def scatter_scan(access, rx_pos, carry0, fslm, k_dop, cfg: TracerConfig):
    """Run the bounce loop; returns the stacked per-bounce outputs."""
    step = partial(bounce_step, access=access, rx_pos=rx_pos,
                   fslm=fslm, k_dop=k_dop, cfg=cfg)
    B = cfg.num_bounces
    if cfg.remat == "hits":
        # save ONLY the named residuals (kernel hit decisions + fetched
        # payload rows): the backward recomputes the elementwise shading
        # in-place — no intersection re-runs, far fewer forward-pass
        # residual materialisations (see TracerConfig.remat)
        step = jax.checkpoint(
            step, policy=jax.checkpoint_policies.save_only_these_names(
                "hit", "payload"))
    elif not cfg.unroll_bounces and cfg.scan_remat == "save_all":
        # scan's default backward re-runs the body (including the
        # intersection queries) to rebuild residuals; saving everything
        # trades device memory for that recompute.  "recompute" keeps the
        # memory-lean default for huge runs.
        step = jax.checkpoint(
            step, policy=jax.checkpoint_policies.everything_saveable)
    _, ys = jax.lax.scan(step, carry0, None, length=B,
                         unroll=B if cfg.unroll_bounces else 1)
    return ys


def assemble_scatter(ys, d0, o0, nrx, ntx, P, B, keep_rays: bool):
    """Reshape stacked scan outputs into the reference ChannelInfo layout
    ``(rx, tx, bounce*path)`` plus the per-bounce RaysInfo."""
    (te_re, te_im, tm_re, tm_im, tau_s, freq_s, dir_rx, ro, rd, ract) = ys
    R = ntx * P

    def to_chan(x):  # [B, NRx, R] -> [NRx, NTx, B*P]
        x = x.reshape(B, nrx, ntx, P)
        return x.transpose(1, 2, 0, 3).reshape(nrx, ntx, B * P)

    def to_chan3(x):  # [B, NRx, R, 3] -> [NRx, NTx, B*P, 3]
        x = x.reshape(B, nrx, ntx, P, 3)
        return x.transpose(1, 2, 0, 3, 4).reshape(nrx, ntx, B * P, 3)

    a_te = (to_chan(te_re) + 1j * to_chan(te_im)).astype(jnp.complex64)
    a_tm = (to_chan(tm_re) + 1j * to_chan(tm_im)).astype(jnp.complex64)
    dir_tx = jnp.broadcast_to(
        d0.reshape(1, ntx, 1, P, 3), (nrx, ntx, B, P, 3)
    ).reshape(nrx, ntx, B * P, 3)

    scatter = ChannelInfo(
        directions_rx=to_chan3(dir_rx), directions_tx=dir_tx,
        a_te=a_te, a_tm=a_tm, tau=to_chan(tau_s), freq_shift=to_chan(freq_s))

    rays_scatter = None
    if keep_rays:
        def to_rays(x0, xs):  # [R,3] + [B, R, 3] -> [NTx, B+1, P, 3]
            allx = jnp.concatenate([x0[None], xs], axis=0)     # [B+1, R, 3]
            return allx.reshape(B + 1, ntx, P, 3).transpose(1, 0, 2, 3)
        act_all = jnp.concatenate([jnp.ones((1, R), bool), ract], axis=0)
        rays_scatter = RaysInfo(
            origins=to_rays(o0, ro), directions=to_rays(d0, rd),
            active=act_all.reshape(B + 1, ntx, P).transpose(1, 0, 2))
    return scatter, rays_scatter


def trace_paths(tris: TriangleSoA,
                materials: MaterialTable,
                rx_pos: jax.Array, tx_pos: jax.Array,
                rx_vel: jax.Array, tx_vel: jax.Array,
                carrier_frequency_ghz,
                cfg: TracerConfig,
                launch_dirs: Optional[jax.Array] = None,
                intersect_fn=None) -> PathsResult:
    """Trace LoS + scatter paths on a single device.  Fully differentiable
    w.r.t. ``materials``, positions, velocities, vertices and carrier
    frequency.  For multi-chip sharded tracing see
    :func:`hermespy_rt_tpu.parallel.trace_paths_sharded`.

    Jit-compatible: wrap in ``jax.jit`` with ``cfg`` static (the public API in
    :mod:`hermespy_rt_tpu.api` does this).
    """
    rx_pos = jnp.asarray(rx_pos, jnp.float32).reshape(-1, 3)
    tx_pos = jnp.asarray(tx_pos, jnp.float32).reshape(-1, 3)
    rx_vel = jnp.asarray(rx_vel, jnp.float32).reshape(-1, 3)
    tx_vel = jnp.asarray(tx_vel, jnp.float32).reshape(-1, 3)
    nrx, ntx = rx_pos.shape[0], tx_pos.shape[0]
    P, B = cfg.num_paths, cfg.num_bounces

    f_hz = jnp.asarray(carrier_frequency_ghz, jnp.float32) * jnp.float32(1e9)
    fslm = jnp.float32(4.0) * PI * f_hz / SPEED_OF_LIGHT
    k_dop = f_hz / SPEED_OF_LIGHT

    if launch_dirs is None:
        dirs_np = fibonacci_sphere(P)
        if cfg.resolved_launch_order == "coherent":
            # same direction set, direction-Morton index assignment: kernel
            # ray blocks become narrow cones instead of whole polar bands, so
            # rays that leave the scene die in whole blocks.
            # Static (numpy) — zero runtime cost; directions_tx keeps every
            # path self-consistent (see TracerConfig.launch_order).
            from .scene.model import _morton_order
            dirs_np = dirs_np[_morton_order(np.asarray(dirs_np))]
        launch_dirs = jnp.asarray(dirs_np)
    eta = precompute_eta(materials, carrier_frequency_ghz)
    access = LocalSceneAccess(tris, intersect_fn, cfg, eta=eta)

    los, rays_los, los_blocked = _los_pass(access, rx_pos, tx_pos, rx_vel,
                                           tx_vel, fslm, k_dop, cfg)

    pattern = (transmit_patterns(ntx * P, B) if cfg.spawn_transmission
               else None)
    carry0 = launch_state(tx_pos, tx_vel, launch_dirs, k_dop,
                          transmit_pattern=pattern)
    o0, d0 = carry0[0], carry0[1]

    ys = scatter_scan(access, rx_pos, carry0, fslm, k_dop, cfg)
    scatter, rays_scatter = assemble_scatter(ys, d0, o0, nrx, ntx, P, B,
                                             cfg.keep_rays)
    return PathsResult(los=los, scatter=scatter, rays_los=rays_los,
                       rays_scatter=rays_scatter, los_blocked=los_blocked)
