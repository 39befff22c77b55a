"""Large-scene path tests (BASELINE.json config 5: 100k+-triangle imported
meshes).  CPU-sized here; chip_smoke.py runs the 131k-triangle city on a
GPU."""
import numpy as np
import jax.numpy as jnp
import pytest

import hermespy_rt_tpu as hrt
from hermespy_rt_tpu.ops.intersect import intersect_jnp
from hermespy_rt_tpu.ops.intersect_pallas import make_pallas_intersect
from hermespy_rt_tpu.scene import flatten_scene, random_soup_scene
from hermespy_rt_tpu.scene.model import _morton_order


def test_large_scene_kernel_agreement(rng):
    """Multi-tile triangle streaming (T >> block_tris) agrees with the jnp
    reference."""
    scene = random_soup_scene(6000, seed=21, extent=80.0)
    soa = flatten_scene(scene, pad_to=128)
    assert soa.pad_triangles >= 6000
    R = 512
    o = rng.uniform(-90, 90, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t1, i1 = intersect_jnp(jnp.asarray(o), jnp.asarray(d), soa,
                           chunk_size=256)
    fn = make_pallas_intersect(soa, block_rays=128, block_tris=256,
                               interpret=True)
    t2, i2 = fn(jnp.asarray(o), jnp.asarray(d))
    agree = (np.asarray(i1) == np.asarray(i2)).mean()
    assert agree > 0.995
    # flip taxonomy: every disagreement must be a
    # provable f32 tie or barycentric-edge case, not an arbitrary error
    from tests.utils import assert_flips_explained
    assert_flips_explained(soa, o, d, t1, i1, t2, i2,
                           label="pallas vs jnp 6k soup")


def test_large_scene_trace_uses_take_gather():
    scene = random_soup_scene(5000, seed=4, extent=50.0)
    cfg = hrt.TracerConfig(num_paths=128, num_bounces=2, backend="jnp",
                           ray_chunk=128, keep_rays=False)
    res = hrt.trace(scene, [[0.0, 0.0, 0.0]], [[5.0, 5.0, 5.0]], config=cfg)
    a = np.asarray(res.scatter.a_te)
    assert np.isfinite(a).all()
    assert (np.abs(a) > 0).sum() > 0


def test_take_gather_matches_onehot_with_grads(street_tris):
    """The big-table 'take' fetch (geometry gather + material-indirect
    eta through the per-material table) must be value-identical to the
    'onehot' fetch — eta[mat][idx] == eta[mat[idx]] bit-exactly — and its
    material gradients must match (same chain, the backward contracts over
    material rows instead of scattering into the triangle table)."""
    import functools
    import jax
    from hermespy_rt_tpu.config import TracerConfig
    from hermespy_rt_tpu.materials import default_materials
    from hermespy_rt_tpu.tracer import trace_paths

    tris = street_tris
    mats = default_materials()
    rx = jnp.asarray([[10.0, 5.0, 2.0]], jnp.float32)
    tx = jnp.asarray([[-20.0, -10.0, 10.0]], jnp.float32)
    z1 = jnp.zeros((1, 3), jnp.float32)

    @functools.partial(jax.jit, static_argnames=("gather",))
    def run(m, gather):
        cfg = TracerConfig(num_paths=512, num_bounces=2, backend="jnp",
                           keep_rays=False, gather=gather,
                           grad_geometry=False)

        def loss(m):
            r = trace_paths(tris, m, rx, tx, z1, z1, jnp.float32(3.0), cfg)
            return (jnp.sum(jnp.abs(r.scatter.a_te) ** 2)
                    + jnp.sum(jnp.abs(r.scatter.a_tm) ** 2)) * 1e9
        v, g = jax.value_and_grad(loss)(m)
        return v, g

    v_t, g_t = run(mats, gather="take")
    v_o, g_o = run(mats, gather="onehot")
    np.testing.assert_array_equal(np.asarray(v_t), np.asarray(v_o))
    import jax
    for a, b in zip(jax.tree_util.tree_leaves(g_t),
                    jax.tree_util.tree_leaves(g_o)):
        a, b = np.asarray(a), np.asarray(b)
        # identical per-ray terms, accumulation order differs (the take
        # backward sums rays into 17 material rows directly; onehot sums
        # into triangle rows then segments by material)
        tol = 1e-5 * max(np.abs(a).max(), 1e-30) + 1e-18
        assert np.abs(a - b).max() <= tol


def test_morton_sort_preserves_results():
    scene = random_soup_scene(500, seed=9, extent=40.0)
    plain = flatten_scene(scene, pad_to=128)
    sorted_ = flatten_scene(scene, pad_to=128, sort_triangles=True)
    assert sorted_.num_triangles == plain.num_triangles
    # same triangle set, different order
    v_plain = np.sort(np.asarray(plain.v0)[:500], axis=0)
    v_sorted = np.sort(np.asarray(sorted_.v0)[:500], axis=0)
    np.testing.assert_allclose(v_plain, v_sorted)

    rng = np.random.default_rng(2)
    o = jnp.asarray(rng.uniform(-50, 50, (256, 3)).astype(np.float32))
    d0 = rng.normal(size=(256, 3)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d = jnp.asarray(d0)
    t1, i1 = intersect_jnp(o, d, plain)
    t2, i2 = intersect_jnp(o, d, sorted_)
    # same nearest distances (identities may differ only on exact ties)
    m = np.asarray(i1) >= 0
    assert (m == (np.asarray(i2) >= 0)).all()
    np.testing.assert_allclose(np.asarray(t1)[m], np.asarray(t2)[m],
                               rtol=1e-6)
    # sorted order improves tile AABB tightness (mean tile bbox volume drops)
    def mean_tile_extent(soa):
        pts = np.asarray(soa.v0)[:500]
        tiles = pts[: (500 // 128) * 128].reshape(-1, 128, 3)
        return float(np.mean(tiles.max(1) - tiles.min(1)))
    assert mean_tile_extent(sorted_) < mean_tile_extent(plain)


def test_morton_order_is_permutation():
    rng = np.random.default_rng(0)
    c = rng.uniform(-10, 10, (777, 3))
    perm = _morton_order(c)
    assert sorted(perm.tolist()) == list(range(777))
