"""Typed configuration for the tracer (the reference has no config system —
all parameters are positional C arguments, /root/reference/inc/compute_paths.h:59-74;
see SURVEY.md §5).
"""
from __future__ import annotations

import dataclasses

__all__ = ["TracerConfig"]


@dataclasses.dataclass(frozen=True)
class TracerConfig:
    """Static tracer parameters (hashable; usable as a jit static argument).

    Attributes:
      num_paths:   rays launched per transmitter (Fibonacci sphere).
      num_bounces: specular bounce depth.
      parity:      "reference" reproduces the reference's quirky-but-observable
                   semantics needed for golden tests (scatter shadow rays are
                   blocked only by hits within 1 unit of *normalized* direction,
                   i.e. 1 metre, /root/reference/src/compute_paths.c:678-683;
                   LoS Doppler uses rx/tx velocity row 0,
                   /root/reference/src/compute_paths.c:573).
                   "physical" uses distance-correct occlusion with an epsilon
                   margin and per-index LoS velocities.
      backend:     intersection backend: "jnp", "pallas" (the Triton
                   kernel; needs a GPU), or "auto" (the kernel on a GPU, jnp
                   on a CPU; see tracer.resolve_backend).
      ray_chunk:   ray-axis chunk for the jnp backend's lax.map blocking.
      unroll_bounces: unroll the bounce scan (num_bounces is small; unrolling
                   lets XLA overlap independent per-bounce work).
      keep_rays:   also return per-bounce ray segments + active masks
                   (RaysInfo parity); disable to save HBM on huge runs.
      occlusion_offset: self-hit epsilon for "physical" occlusion mode.
    """

    num_paths: int = 10_000
    num_bounces: int = 3
    parity: str = "reference"
    backend: str = "auto"
    ray_chunk: int = 4096
    unroll_bounces: bool = True
    # bounce-scan backward policy (unroll_bounces=False only): "save_all"
    # stores per-bounce intermediates so the backward never re-runs the
    # intersection kernels (fast, more HBM); "recompute" is the lean
    # default-JAX behaviour for runs that would not fit otherwise.
    scan_remat: str = "save_all"
    keep_rays: bool = True
    occlusion_offset: float = 1e-4
    # any-hit shadow queries (physical parity only, and never under
    # `transmission`): physical mode consumes only `blocked` from a shadow
    # query, so the kernel may stop a ray block once every ray has an
    # in-range hit instead of scanning to the nearest — trace outputs are
    # bit-identical (tests/test_config5.py::
    # test_any_hit_shadow_walk_trace_invariant).  Reference parity always needs
    # the nearest blocker (θ-clobber reads its normal).  Off = force
    # nearest-hit shadow queries everywhere (A/B control).
    shadow_any_hit: bool = True
    # hit-payload fetch strategy: "take" = plain XLA gather (the default:
    # 6.3 vs 10.6 ms for the street fwd+bwd step on an H100, PERF.md);
    # "onehot" = exact one-hot matmul against the fused per-triangle table
    # (ops/fetch.py; its backward is a matmul too — the one-hot operand is
    # [rays, triangles], so small scenes only).
    gather: str = "take"
    # Max rays per shadow-ray query: the scatter pass batches all
    # NRx * num_paths shadow rays into one nearest-hit call, whose operands
    # scale with the ray count.  Queries beyond this are split into equal RX
    # groups run sequentially under lax.map — same results, bounded memory.
    rx_query_rays: int = 1 << 22
    # Launch-direction assignment: "fibonacci" enumerates paths exactly like
    # the reference (/root/reference/src/compute_paths.c:442-456 — adjacent
    # path indices are ~2.4 rad apart in azimuth, so a kernel ray block
    # spans a whole polar band); "coherent" launches the SAME direction set
    # but assigns indices in direction-Morton order, making every ray block
    # a narrow cone — dead rays die in tighter index bands, so whole blocks
    # skip.  Outputs remain self-consistent (directions_tx reports each
    # path's true direction); only the path <-> direction labelling differs
    # from the reference, so parity suites use "fibonacci".  "auto"
    # (default): "fibonacci" under parity="reference" (path-indexed golden
    # comparisons stay valid), "coherent" otherwise.
    launch_order: str = "auto"
    # Dead-ray skipping: hand the kernel the activity mask so it skips ray
    # blocks in which every ray is dead.  Exact (a forced miss for a dead
    # ray is semantically identical to ignoring its result); rays die in
    # contiguous launch-index bands, so no reordering is needed.  Pays from
    # bounce 1 on, once rays start leaving the scene.
    compact_rays: bool = False
    # Occlusion with penetration loss (physical mode only): LoS paths and
    # scatter shadow rays blocked by an obstacle are attenuated by the
    # obstacle's ITU transmission coefficients (eqs. 31c/31d — the extension
    # the reference left as TODO) instead of zeroed.  Nearest blocker only.
    transmission: bool = False
    # Backward rematerialisation policy for the bounce step: "none" saves
    # whatever XLA decides (every fusion boundary becomes a forward-pass
    # materialisation kept for the backward); "hits" checkpoints each bounce
    # saving ONLY the intersection decisions and fetched payload rows
    # (tagged via checkpoint_name) — the elementwise shading recomputes
    # inside the backward, where it fuses with the cotangent math.  The
    # intersection is never re-run (its outputs are exactly the saved names).
    remat: str = "none"
    # Differentiability scope: True (default) keeps every fetched triangle
    # quantity differentiable (gradients flow to scene vertices, normals and
    # mesh velocities through the bounce chain).  False marks the *geometry*
    # payload (v0/e1/e2/normal/velocity) as non-differentiable, which makes
    # the whole cross-bounce geometric chain (hit points, reflections,
    # angles, delays) constant w.r.t. every differentiable input except the
    # launch state — XLA then dead-code-eliminates its entire backward.
    # Gradients w.r.t. MATERIALS are bit-identical either way (materials
    # enter only through the eta columns, whose chain never passes through
    # geometry); gradients w.r.t. vertices/velocities/TX-TO-scene paths are
    # zeroed.  Use for material-calibration training loops: the backward
    # pass shrinks to the material chain.
    grad_geometry: bool = True
    # Payload-table placement under triangle sharding (trace_paths_sharded
    # with a tris mesh axis > 1).  The 27-column payload table is 108 B per
    # triangle.  False REPLICATES it per shard: every per-hit fetch and the
    # parity theta-clobber normal fetch become local gathers with ZERO
    # collectives.  True shards it (masked-psum fetch) for scenes whose
    # replicated table would not fit.  "auto" replicates up to 2^22 padded
    # triangles (~450 MB/shard).
    tri_shard_table: "bool | str" = "auto"
    # Transmission-path spawning (physical mode only): rays are partitioned
    # over all 2**num_bounces reflect/transmit interaction sequences (static
    # shapes, no dynamic tree growth); a "transmit" interaction continues
    # straight through the surface with the eq. 31c/31d coefficients.  This
    # realises refracted *continuation* paths, e.g. TX -> through wall ->
    # reflect -> RX.  Costs sampling density: each pure-reflection pattern
    # keeps num_paths / 2**num_bounces rays.
    spawn_transmission: bool = False
    # Continuation geometry for "transmit" interactions (spawn_transmission
    # only).  "straight": pass through unchanged — the ITU building-entry
    # slab model (a thin wall refracts in and out; the exit ray is parallel
    # to the incident one).  "snell": bend by Snell's law at the interface
    # (air -> medium, n = Re(sqrt(eta))) — the single-interface model the
    # reference left unimplemented (/root/reference/src/compute_paths.c:725-728).
    # Differentiable w.r.t. the material table through the bent direction.
    refraction: str = "straight"

    @property
    def resolved_launch_order(self) -> str:
        """'auto' -> 'fibonacci' under parity='reference' (path-indexed
        golden comparisons stay valid), 'coherent' otherwise."""
        if self.launch_order != "auto":
            return self.launch_order
        return "fibonacci" if self.parity == "reference" else "coherent"

    def __post_init__(self):
        if self.parity not in ("reference", "physical"):
            raise ValueError(f"parity must be 'reference' or 'physical', got {self.parity!r}")
        if self.backend not in ("jnp", "pallas", "auto"):
            raise ValueError(f"backend must be 'jnp', 'pallas' or 'auto', got {self.backend!r}")
        if self.num_paths <= 0 or self.num_bounces <= 0:
            raise ValueError("num_paths and num_bounces must be > 0")
        if self.remat not in ("none", "hits"):
            raise ValueError(f"remat must be 'none' or 'hits', got "
                             f"{self.remat!r}")
        if self.scan_remat not in ("save_all", "recompute"):
            raise ValueError(f"scan_remat must be 'save_all' or 'recompute',"
                             f" got {self.scan_remat!r}")
        if self.gather not in ("take", "onehot"):
            raise ValueError("gather must be 'take' or 'onehot', "
                             f"got {self.gather!r}")
        if self.launch_order not in ("auto", "fibonacci", "coherent"):
            raise ValueError("launch_order must be 'auto', 'fibonacci' or "
                             f"'coherent', got {self.launch_order!r}")
        if self.launch_order == "coherent" and self.parity == "reference":
            import warnings
            warnings.warn(
                "launch_order='coherent' relabels path <-> direction "
                "assignments: outputs stay self-consistent but path-indexed "
                "comparisons against the C reference will mismatch; parity "
                "suites should use launch_order='fibonacci'.", stacklevel=2)
        if self.rx_query_rays <= 0:
            raise ValueError("rx_query_rays must be > 0, got "
                             f"{self.rx_query_rays}")
        if self.transmission and self.parity != "physical":
            raise ValueError("transmission=True requires parity='physical' "
                             "(the reference semantics zero blocked paths)")
        if self.spawn_transmission and self.parity != "physical":
            raise ValueError("spawn_transmission=True requires "
                             "parity='physical' (the reference has no "
                             "refraction branch to be parity-faithful to)")
        if self.tri_shard_table not in (False, True, "auto"):
            raise ValueError("tri_shard_table must be False, True or "
                             f"'auto', got {self.tri_shard_table!r}")
        if self.refraction not in ("straight", "snell"):
            raise ValueError("refraction must be 'straight' or 'snell', "
                             f"got {self.refraction!r}")
        if self.refraction == "snell" and not self.spawn_transmission:
            raise ValueError("refraction='snell' only affects transmitted "
                             "continuations; enable spawn_transmission=True")
