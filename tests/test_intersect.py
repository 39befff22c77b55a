"""Intersection op unit tests: jnp Möller–Trumbore vs an independent float64
numpy model, plus the reference's epsilon/tie-break semantics
(/root/reference/src/compute_paths.c:237-287)."""
import numpy as np
import jax.numpy as jnp

from hermespy_rt_tpu.ops.intersect import intersect_jnp, recompute_hit_t
from hermespy_rt_tpu.scene import flatten_scene, box_scene, random_soup_scene, HostScene, HostMesh


def _numpy_nearest(o, d, soa):
    """Independent float64 brute-force oracle."""
    v0 = np.asarray(soa.v0, np.float64)
    e1 = np.asarray(soa.e1, np.float64)
    e2 = np.asarray(soa.e2, np.float64)
    out_t = np.full(o.shape[0], np.inf)
    out_i = np.full(o.shape[0], -1, np.int64)
    for r in range(o.shape[0]):
        pvec = np.cross(d[r], e2)
        det = np.sum(e1 * pvec, -1)
        ok = np.abs(det) > 1e-12
        s = o[r] - v0
        u = np.sum(s * pvec, -1) / np.where(ok, det, 1)
        qvec = np.cross(s, e1)
        v = np.sum(d[r] * qvec, -1) / np.where(ok, det, 1)
        t = np.sum(e2 * qvec, -1) / np.where(ok, det, 1)
        valid = ok & (u >= -1e-9) & (u <= 1 + 1e-9) & (v >= -1e-9) & (u + v <= 1 + 1e-9) & (t > 1e-7)
        if valid.any():
            tm = np.where(valid, t, np.inf)
            out_i[r] = np.argmin(tm)
            out_t[r] = tm[out_i[r]]
    return out_t, out_i


def test_against_float64_oracle(rng):
    soa = flatten_scene(random_soup_scene(200, seed=3), pad_to=128)
    R = 256
    o = rng.uniform(-60, 60, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t, idx = intersect_jnp(jnp.asarray(o), jnp.asarray(d), soa)
    t, idx = np.asarray(t), np.asarray(idx)
    t64, i64 = _numpy_nearest(o.astype(np.float64), d.astype(np.float64), soa)
    hit_agree = (idx >= 0) == (i64 >= 0)
    assert hit_agree.mean() > 0.99  # allow f32-vs-f64 edge flips
    m = hit_agree & (idx >= 0)
    same_tri = idx[m] == i64[m]
    assert same_tri.mean() > 0.99
    np.testing.assert_allclose(t[m][same_tri], t64[m][same_tri], rtol=1e-4)


def test_miss_and_degenerate_padding():
    soa = flatten_scene(box_scene(), pad_to=128)
    # ray pointing away from the box
    o = jnp.asarray([[0.0, 0.0, 10.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    t, idx = intersect_jnp(o, d, soa)
    assert int(idx[0]) == -1 and not np.isfinite(float(t[0]))
    # zero-direction ray never hits (degenerate det)
    t, idx = intersect_jnp(o, jnp.zeros((1, 3)), soa)
    assert int(idx[0]) == -1


def test_nearest_and_tiebreak():
    # two parallel plates; ray must hit the nearer; coplanar duplicate
    # triangles must resolve to the lowest index (C first-strict-min order).
    verts = np.array([[-1, -1, 1], [1, -1, 1], [0, 1, 1],
                      [-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32)
    idxs = np.array([[0, 1, 2], [3, 4, 5]], np.uint32)
    soa = flatten_scene(HostScene([HostMesh(verts, idxs)]), pad_to=128)
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    t, idx = intersect_jnp(o, d, soa)
    assert int(idx[0]) == 0 and abs(float(t[0]) - 1.0) < 1e-6

    dup = np.array([[0, 1, 2], [0, 1, 2], [3, 4, 5]], np.uint32)
    soa2 = flatten_scene(HostScene([HostMesh(verts, dup)]), pad_to=128)
    t2, idx2 = intersect_jnp(o, d, soa2)
    assert int(idx2[0]) == 0  # ties -> first triangle


def test_parametric_distance_units():
    # unnormalised direction: t is in units of |d| (LoS occlusion contract,
    # /root/reference/src/compute_paths.c:548).
    soa = flatten_scene(box_scene(), pad_to=128)
    o = jnp.asarray([[0.0, 0.0, 2.0]])
    d = jnp.asarray([[0.0, 0.0, -4.0]])  # wall at z=0, |d| = 4
    t, idx = intersect_jnp(o, d, soa)
    assert int(idx[0]) >= 0
    assert abs(float(t[0]) - 0.5) < 1e-6


def test_chunked_matches_unchunked():
    soa = flatten_scene(random_soup_scene(100, seed=5), pad_to=128)
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(-40, 40, (1000, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(1000, 3)).astype(np.float32))
    t1, i1 = intersect_jnp(o, d, soa, chunk_size=4096)
    t2, i2 = intersect_jnp(o, d, soa, chunk_size=128)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))


def test_recompute_hit_t_matches_and_is_differentiable():
    import jax
    soa = flatten_scene(box_scene(), pad_to=128)
    o = jnp.asarray([[0.0, 0.0, 2.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    t, idx = intersect_jnp(o, d, soa)
    t2 = recompute_hit_t(o, d, idx, soa)
    np.testing.assert_allclose(float(t[0]), float(t2[0]), rtol=1e-6)

    def dist(opos):
        return recompute_hit_t(opos, d, idx, soa)[0]
    g = jax.grad(dist)(o)
    # moving origin up increases hit distance with d = -z
    np.testing.assert_allclose(np.asarray(g)[0], [0, 0, 1], atol=1e-5)
