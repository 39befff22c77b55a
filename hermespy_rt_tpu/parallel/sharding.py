"""Multi-chip SPMD tracing: shard_map over device meshes.

The reference has no parallelism of any kind (single C thread, SURVEY.md §2
"Parallelism components: NONE").  The scaling design follows the
semantics of the workload instead:

* **Ray sharding (DP-analog)** — the flattened ``(tx*path)`` ray axis is
  embarrassingly parallel (the reference bounce loop touches only per-ray
  state, /root/reference/src/compute_paths.c:597-729), so per-ray state and
  per-bounce outputs shard over the ``rays`` mesh axis with zero forward
  communication.  Gradients w.r.t. the replicated scene/material parameters
  are all-reduced automatically by shard_map's transpose (psum over ``rays``),
  which XLA lowers to collectives over the device interconnect (NCCL on
  GPUs) and overlaps with the backward pass.
* **Triangle sharding (TP-analog)** — for scenes too large to replicate, the
  triangle axis shards over a second ``tris`` mesh axis.  The nearest-hit
  reduction is an associative min (/root/reference/src/compute_paths.c:275-284),
  so each device computes a local argmin and the winner is combined by a
  lexicographic (distance, lowest global index) min across shards — the
  reference's first-min tie-break.  The winning triangle's payload
  (vertices, normal, velocity, material) is read from a replicated table or
  fetched with a masked psum — exactly one shard owns the winner.
* **Multi-host** — ``jax.distributed.initialize`` + the same mesh spanning
  all processes; nothing else changes (XLA's collectives take the place of
  a hand-written NCCL/MPI layer; SURVEY.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import TracerConfig
from ..materials import MaterialTable
from ..ops.fresnel import precompute_eta
from ..ops.geometry import fibonacci_sphere
from ..scene.model import TriangleSoA
from ..tracer import (LocalSceneAccess, PathsResult, _los_pass,
                      assemble_scatter, launch_state, scatter_scan)

__all__ = ["default_mesh", "trace_paths_sharded", "TriShardedSceneAccess",
           "initialize_distributed"]

_I32_MAX = np.int32(2**31 - 1)


def _no_intersect(*a, **k):  # replicated-table access never intersects
    raise RuntimeError("the replicated-payload access is fetch-only")


def initialize_distributed(**kwargs):
    """Multi-host bring-up: thin wrapper over ``jax.distributed.initialize``
    (coordinator address etc. from env or kwargs).  Call once per host before
    building a mesh that spans processes."""
    jax.distributed.initialize(**kwargs)


def default_mesh(num_ray_shards: Optional[int] = None,
                 num_tri_shards: int = 1, devices=None) -> Mesh:
    """Build a ``(rays, tris)`` device mesh.  With ``num_tri_shards == 1`` the
    scene is replicated and only rays shard."""
    devices = list(devices if devices is not None else jax.devices())
    if num_ray_shards is None:
        num_ray_shards = len(devices) // num_tri_shards
    n = num_ray_shards * num_tri_shards
    if n > len(devices):
        raise ValueError(f"mesh {num_ray_shards}x{num_tri_shards} needs {n} "
                         f"devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(num_ray_shards, num_tri_shards)
    return Mesh(arr, ("rays", "tris"))


class TriShardedSceneAccess:
    """SceneAccess over a triangle shard; combines results over ``axis_name``.

    ``tris_local`` holds this device's contiguous triangle slab; global
    triangle ids are ``local + axis_index * shard_size`` so that the cross-
    shard ``pmin`` tie-break reproduces the single-device (reference) order.
    """

    def __init__(self, tris_local: TriangleSoA, axis_name: str,
                 cfg: TracerConfig, eta=None, intersect_fn=None,
                 tris_full: Optional[TriangleSoA] = None):
        self.local = LocalSceneAccess(tris_local, intersect_fn, cfg, eta=eta)
        self.axis = axis_name
        self.shard_size = tris_local.v0.shape[0]
        self.offset = jax.lax.axis_index(axis_name) * self.shard_size
        self.axis_size = jax.lax.axis_size(axis_name)
        # Replicated-payload mode: the 27-column payload TABLE is 108 B per
        # triangle and fits replicated far past the scenes triangle sharding
        # exists for.  With a replicated table every per-hit fetch and the
        # parity theta-clobber normal fetch become LOCAL gathers — zero
        # collectives.  Global hit ids index the full table directly (shard
        # offsets already applied by intersect).
        self.full = None
        if tris_full is not None:
            self.full = LocalSceneAccess(
                tris_full, intersect_fn=_no_intersect, cfg=cfg, eta=eta)

    def _lex_min(self, t_loc, i_glob):
        """Global lexicographic (t, idx) min over the triangle shards.

        Fast path: a butterfly of log2(n) ``ppermute`` exchanges, each
        moving ONE packed f32[2, R] array (t row + exactly-f32-representable
        global index row) and folding with a local lexicographic
        compare-select — the reference's first-strict-min order under any
        shard count, with one exchange per mesh level instead of two chained
        ``pmin`` all-reduces (distance, then masked index).  Falls back to
        the double-pmin when the axis size is not a power of two or indices
        exceed f32's 2^24 exact-integer range."""
        n = self.axis_size
        total = n * self.shard_size
        if n & (n - 1) == 0 and total <= (1 << 24):
            miss = jnp.float32(1 << 24)
            i_f = jnp.where(i_glob < _I32_MAX, i_glob.astype(jnp.float32),
                            miss)
            pair = jnp.stack([t_loc, i_f])                    # [2, R]
            for k in range(n.bit_length() - 1):
                perm = [(r, r ^ (1 << k)) for r in range(n)]
                other = jax.lax.ppermute(pair, self.axis, perm)
                t_o, i_o = other[0], other[1]
                better = (t_o < pair[0]) | ((t_o == pair[0])
                                            & (i_o < pair[1]))
                pair = jnp.where(better[None], other, pair)
            t_min = pair[0]
            i_min = jnp.where(pair[1] < miss, pair[1].astype(jnp.int32),
                              _I32_MAX)
            return t_min, i_min
        t_min = jax.lax.pmin(t_loc, self.axis)
        cand = jnp.where((t_loc == t_min) & (i_glob < _I32_MAX), i_glob,
                         _I32_MAX)
        return t_min, jax.lax.pmin(cand, self.axis)

    def intersect(self, o, d, t_max=None, exclude=None, live=None,
                  any_hit=False):
        # decisions only — see LocalSceneAccess.intersect (also: the min
        # combiners have no differentiation rule, and must never need one)
        o = jax.lax.stop_gradient(o)
        d = jax.lax.stop_gradient(d)
        if exclude is not None:
            # global -> shard-local id; out-of-shard ids fall outside
            # [0, shard_size) and match nothing
            exclude = jnp.asarray(exclude, jnp.int32) - self.offset
        t_loc, i_loc = self.local.intersect(o, d, t_max, exclude, live,
                                            any_hit=any_hit)
        i_glob = jnp.where(i_loc >= 0, i_loc + self.offset, _I32_MAX)
        t_min, i_min = self._lex_min(t_loc, i_glob)
        idx = jnp.where(jnp.isfinite(t_min) & (i_min < _I32_MAX), i_min, -1)
        return t_min, idx.astype(jnp.int32)

    def _owned(self, idx_safe_global):
        li = idx_safe_global - self.offset
        mine = (li >= 0) & (li < self.shard_size)
        return jnp.clip(li, 0, self.shard_size - 1), mine

    def fetch(self, idx_safe):
        if self.full is not None:
            # replicated table: a LOCAL gather — no collective at all
            return self.full.fetch(idx_safe)
        li, mine = self._owned(idx_safe)
        # ONE collective for the whole 27-column payload: psum the fused
        # [..., 27] row (masked to the owning shard) and split afterwards,
        # instead of 17 per-leaf psums (5 vec3 + 12 eta) through the split
        # pytree — same values, same gradients (stop_gradient commutes with
        # psum), 1/17th the collective launches per bounce.
        row = self.local._rows(li)
        row = jax.lax.psum(row * mine.astype(jnp.float32)[..., None],
                           self.axis)
        return self.local.split_rows(row)

    def normal_at(self, idx_safe):
        if self.full is not None:
            return self.full.normal_at(idx_safe)
        li, mine = self._owned(idx_safe)
        n = self.local.normal_at(li)
        return jax.lax.psum(n * mine.astype(jnp.float32)[..., None], self.axis)


def _tris_specs(tris: TriangleSoA, shard: bool):
    """PartitionSpec pytree for a TriangleSoA (leading axis = triangles)."""
    def spec(x):
        if not shard:
            return P()
        return P(*(("tris",) + (None,) * (x.ndim - 1)))
    return jax.tree.map(spec, tris)


def _round_up(x, m):
    return -(-x // m) * m


def trace_paths_sharded(tris: TriangleSoA,
                        materials: MaterialTable,
                        rx_pos, tx_pos, rx_vel, tx_vel,
                        carrier_frequency_ghz,
                        cfg: TracerConfig,
                        mesh: Optional[Mesh] = None,
                        launch_dirs=None,
                        intersect_factory=None) -> PathsResult:
    """Multi-device trace over a ``(rays, tris)`` mesh.

    Semantically identical to :func:`hermespy_rt_tpu.tracer.trace_paths`
    (same outputs bit-for-mask); differentiable w.r.t. materials, positions,
    velocities and (replicated-mode) scene geometry, with parameter gradients
    psum-reduced across ray shards automatically.

    ``intersect_factory`` (optional) maps a (shard-local) TriangleSoA to an
    ``intersect_fn``; by default the config's backend policy picks one
    (:func:`hermespy_rt_tpu.tracer.resolve_backend`).
    """
    make_fn = intersect_factory or (lambda t: None)
    from ..tracer import PI, SPEED_OF_LIGHT

    if mesh is None:
        mesh = default_mesh()
    n_rays = mesh.shape["rays"]
    n_tris = mesh.shape.get("tris", 1)
    tri_sharded = n_tris > 1

    rx_pos = jnp.asarray(rx_pos, jnp.float32).reshape(-1, 3)
    tx_pos = jnp.asarray(tx_pos, jnp.float32).reshape(-1, 3)
    rx_vel = jnp.asarray(rx_vel, jnp.float32).reshape(-1, 3)
    tx_vel = jnp.asarray(tx_vel, jnp.float32).reshape(-1, 3)
    nrx, ntx = rx_pos.shape[0], tx_pos.shape[0]
    P_, B = cfg.num_paths, cfg.num_bounces
    R = ntx * P_
    if R % n_rays:
        raise ValueError(f"ntx*num_paths = {R} must divide the rays axis "
                         f"({n_rays}); pad num_paths")

    if tri_sharded:
        t_pad = tris.v0.shape[0]
        need = _round_up(t_pad, n_tris * 128)
        if need > t_pad:
            def pad(x):
                w = [(0, need - t_pad)] + [(0, 0)] * (x.ndim - 1)
                return jnp.pad(x, w)
            tris = dataclasses.replace(
                tris, **{f.name: pad(getattr(tris, f.name))
                         for f in dataclasses.fields(tris)
                         if f.name != "num_triangles"})

    f_hz = jnp.asarray(carrier_frequency_ghz, jnp.float32) * jnp.float32(1e9)
    fslm = jnp.float32(4.0) * PI * f_hz / SPEED_OF_LIGHT
    k_dop = f_hz / SPEED_OF_LIGHT

    if launch_dirs is None:
        dirs_np = fibonacci_sphere(P_)
        if cfg.resolved_launch_order == "coherent":
            from ..scene.model import _morton_order
            dirs_np = dirs_np[_morton_order(np.asarray(dirs_np))]
        launch_dirs = jnp.asarray(dirs_np)
    eta = precompute_eta(materials, carrier_frequency_ghz)

    # LoS is O(nrx*ntx) — replicated, outside the shard_map.
    los, rays_los, los_blocked = _los_pass(
        LocalSceneAccess(tris, make_fn(tris), cfg, eta=eta),
        rx_pos, tx_pos, rx_vel, tx_vel, fslm, k_dop, cfg)

    from ..tracer import transmit_patterns
    pattern = (transmit_patterns(R, B) if cfg.spawn_transmission else None)
    carry0 = launch_state(tx_pos, tx_vel, launch_dirs, k_dop,
                          transmit_pattern=pattern)
    o0, d0 = carry0[0], carry0[1]

    ray_spec = lambda x: P(*(("rays",) + (None,) * (x.ndim - 1)))
    carry_specs = tuple(ray_spec(c) for c in carry0)

    # Payload-table placement (TracerConfig.tri_shard_table): replicating
    # the 108 B/tri payload table while the triangles stay sharded turns
    # every per-hit fetch + theta-clobber normal fetch into local gathers —
    # zero collectives.
    t_padded = tris.v0.shape[0]
    tst = cfg.tri_shard_table
    rep_table = tri_sharded and not (
        tst is True or (tst == "auto" and t_padded > (1 << 22)))

    def body(tris_l, eta_l, rx_pos_l, fslm_l, k_dop_l, *rest):
        if rep_table:
            tris_f, *carry = rest
        else:
            tris_f, carry = None, rest
        if tri_sharded:
            access = TriShardedSceneAccess(tris_l, "tris", cfg, eta=eta_l,
                                           intersect_fn=make_fn(tris_l),
                                           tris_full=tris_f)
        else:
            access = LocalSceneAccess(tris_l, make_fn(tris_l), cfg,
                                      eta=eta_l)
        return scatter_scan(access, rx_pos_l, tuple(carry), fslm_l,
                            k_dop_l, cfg)

    # per-bounce outputs: [B, NRx, R]-shaped (rays last) except dir_rx
    # [B, NRx, R, 3] and — only when keep_rays — rays o/d [B, R, 3] /
    # active [B, R] (None = empty pytree nodes otherwise).
    out_specs = (
        P(None, None, "rays"), P(None, None, "rays"),
        P(None, None, "rays"), P(None, None, "rays"),
        P(None, None, "rays"), P(None, None, "rays"),
        P(None, None, "rays", None),
    ) + ((P(None, "rays", None), P(None, "rays", None), P(None, "rays"))
         if cfg.keep_rays else (None, None, None))
    extra = (tris,) if rep_table else ()
    extra_specs = ((_tris_specs(tris, False),) if rep_table else ())
    ys = jax.shard_map(
        body, mesh=mesh,
        in_specs=(_tris_specs(tris, tri_sharded), P(), P(), P(), P())
        + extra_specs + carry_specs,
        out_specs=out_specs,
        check_vma=False,
    )(tris, eta, rx_pos, fslm, k_dop, *extra, *carry0)

    scatter, rays_scatter = assemble_scatter(ys, d0, o0, nrx, ntx, P_, B,
                                             cfg.keep_rays)
    return PathsResult(los=los, scatter=scatter, rays_los=rays_los,
                       rays_scatter=rays_scatter, los_blocked=los_blocked)
