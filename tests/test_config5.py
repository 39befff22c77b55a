"""BASELINE config-5 composition tests (CPU-sized): the Sionna city
importer end to end, and the intersection kernel (interpret mode) running
*under* triangle sharding on the virtual (rays, tris) mesh — the composition
``chip_smoke.py --multi`` exercises at 131k triangles on four GPUs.

Reference anchor: the scale regime the reference concedes with its
``TODO BVH`` comment (/root/reference/src/compute_paths.c:246) and the
Sionna converter inputs (/root/reference/src/scene_fromSionna.c:255-454).
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

from config5_scene import make_city  # noqa: E402
from hermespy_rt_tpu.config import TracerConfig  # noqa: E402
from hermespy_rt_tpu.materials import default_materials  # noqa: E402
from hermespy_rt_tpu.ops.intersect_pallas import make_pallas_intersect  # noqa: E402
from hermespy_rt_tpu.parallel import default_mesh, trace_paths_sharded  # noqa: E402
from hermespy_rt_tpu.scene import (flatten_scene, load_scene,  # noqa: E402
                                   random_soup_scene)
from hermespy_rt_tpu.tracer import trace_paths  # noqa: E402

RX = np.array([[4.0, -3.0, 1.5]], np.float32)
TX = np.array([[-6.0, 5.0, 4.0]], np.float32)
Z = np.zeros((1, 3), np.float32)


def _kernel(tris):
    """Interpret-mode kernel with small tiles, so a CPU-sized shard still
    spans several ray blocks and triangle tiles."""
    return make_pallas_intersect(tris, block_rays=64, block_tris=32,
                                 interpret=True)


def test_city_scene_imports(tmp_path):
    """XML + binary PLY + to_world translate + ITU material refs, small."""
    xml = make_city(str(tmp_path), n_buildings=4, sub=2, ground_sub=4)
    scene = load_scene(xml)
    tris = flatten_scene(scene, sort_triangles=True)
    # 4 buildings * 12 faces * 2^2 + 2 * 4^2 ground triangles
    assert tris.num_triangles == 4 * 12 * 4 + 32
    names = [m.name for m in scene.meshes]
    assert {"ground", "buildings"} <= set(names)
    mats = {m.material_index for m in scene.meshes}
    assert len(mats) == 2  # medium_dry_ground + concrete resolve distinctly
    # the to_world z-lift must be baked into the building vertices: every
    # building-bottom vertex sits at exactly zlift, not 0
    bld = [m for m in scene.meshes if m.name == "buildings"][0]
    assert float(bld.vertices[:, 2].min()) == pytest.approx(0.05)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
def test_walk_under_tri_sharding(mesh_shape):
    """The intersection kernel inside TriShardedSceneAccess must reproduce
    the single-device jnp trace bit-for-bit (each shard scans its own slab;
    the cross-shard lexicographic min keeps the first-min tie-break)."""
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    tris = flatten_scene(random_soup_scene(300, seed=5, extent=12.0),
                         sort_triangles=True)
    base_cfg = TracerConfig(num_paths=256, num_bounces=2, backend="jnp",
                            keep_rays=False)
    ref = trace_paths(tris, default_materials(), RX, TX, Z, Z, 3.0,
                      base_cfg)
    mesh = default_mesh(*mesh_shape)
    got = jax.jit(lambda m: trace_paths_sharded(
        tris, m, RX, TX, Z, Z, 3.0, base_cfg, mesh=mesh,
        intersect_factory=_kernel))(default_materials())
    for field in ("a_te", "a_tm", "tau", "directions_rx"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref.scatter, field)),
            np.asarray(getattr(got.scatter, field)), err_msg=field)


def test_any_hit_shadow_walk_trace_invariant():
    """Physical-parity traces route shadow queries through the kernel's
    any-hit early-out.  Although the raw (t, idx) a shadow
    query returns may then name a different (non-nearest) blocker, every
    trace output must be bit-identical to the nearest-hit jnp path: the
    physical mode consumes only `blocked` from the query, and recorded
    hits always satisfy t <= t_lim."""
    tris = flatten_scene(random_soup_scene(600, seed=11, extent=14.0),
                         sort_triangles=True)
    kw = dict(num_paths=512, num_bounces=3, keep_rays=False,
              parity="physical")
    ref = trace_paths(tris, default_materials(), RX, TX, Z, Z, 3.0,
                      TracerConfig(backend="jnp", **kw))
    got = trace_paths(tris, default_materials(), RX, TX, Z, Z, 3.0,
                      TracerConfig(**kw), intersect_fn=_kernel(tris))
    occl = np.abs(np.asarray(got.scatter.a_te)) == 0
    assert occl.any() and not occl.all(), "fixture must mix blocked/clear"
    for field in ("a_te", "a_tm", "tau", "directions_rx", "freq_shift"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref.scatter, field)),
            np.asarray(getattr(got.scatter, field)), err_msg=field)


def test_walk_sharded_gradients_finite():
    """fwd+bwd through the kernel + tri-sharding: material and TX-position
    gradients must be finite and nonzero (the config-5 training step)."""
    tris = flatten_scene(random_soup_scene(300, seed=5, extent=12.0),
                         sort_triangles=True)
    cfg = TracerConfig(num_paths=128, num_bounces=2, keep_rays=False,
                       parity="physical")
    mesh = default_mesh(4, 2)
    mats = default_materials()
    tx = jnp.asarray(TX)

    def loss_fn(m, tx_):
        r = trace_paths_sharded(tris, m, RX, tx_, Z, Z, 3.0, cfg, mesh=mesh,
                                intersect_factory=_kernel)
        return (jnp.sum(jnp.abs(r.scatter.a_te) ** 2)
                + jnp.sum(jnp.abs(r.scatter.a_tm) ** 2)) * 1e9

    v, g = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(mats, tx)
    leaves = np.concatenate([np.asarray(x).ravel()
                             for x in jax.tree_util.tree_leaves(g)])
    assert np.isfinite(leaves).all()
    assert (leaves != 0).any()
    assert np.isfinite(float(v))
