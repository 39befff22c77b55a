"""The Pallas (Triton) intersection kernel in interpret mode against the jnp
reference ``intersect_jnp``: nearest hits, exclusion, range limits, dead
ray blocks, any-hit queries, ragged ray counts and tile sizes.  The same
kernel compiled for a GPU is checked by ``test_kernel_compiled_on_gpu``
(marked ``gpu``) and by chip_smoke.py phase b at 2^20 rays."""
import numpy as np
import jax.numpy as jnp
import pytest

from hermespy_rt_tpu.config import TracerConfig
from hermespy_rt_tpu.materials import default_materials
from hermespy_rt_tpu.ops.intersect import intersect_jnp
from hermespy_rt_tpu.ops.intersect_pallas import (make_pallas_intersect,
                                                  pallas_intersect)
from hermespy_rt_tpu.scene import (HostMesh, HostScene, box_scene,
                                   flatten_scene, random_soup_scene)
from hermespy_rt_tpu.tracer import trace_paths
from tests.utils import assert_flips_explained

BR, BT = 32, 32


def _soup():
    return flatten_scene(random_soup_scene(300, seed=5, extent=12.0))


def _rays(tris, n, seed=0):
    rng = np.random.default_rng(seed)
    v = np.asarray(tris.v0)[:tris.num_triangles]
    lo, hi = v.min(0) - 1.0, v.max(0) + 1.0
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _kernel(tris, **kw):
    kw.setdefault("block_rays", BR)
    kw.setdefault("block_tris", BT)
    return make_pallas_intersect(tris, interpret=True, **kw)


def _check(tris, o, d, t1, i1, t2, i2, label):
    """Flips must be edge/tie cases; agreeing hits match in t."""
    t1, i1, t2, i2 = map(np.asarray, (t1, i1, t2, i2))
    assert_flips_explained(tris, o, d, t1, i1, t2, i2, label=label)
    same = (i1 == i2) & (i1 >= 0)
    np.testing.assert_allclose(t2[same], t1[same], rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("scene", ["soup", "box", "street"])
def test_kernel_matches_jnp(scene, street_tris):
    tris = {"soup": _soup, "box": lambda: flatten_scene(box_scene()),
            "street": lambda: street_tris}[scene]()
    o, d = _rays(tris, 600, seed=1)
    t1, i1 = intersect_jnp(jnp.asarray(o), jnp.asarray(d), tris)
    t2, i2 = _kernel(tris)(jnp.asarray(o), jnp.asarray(d))
    assert (np.asarray(i1) >= 0).mean() > 0.2, "fixture must hit something"
    _check(tris, o, d, t1, i1, t2, i2, scene)


@pytest.mark.parametrize("n_rays", [1, 31, 33, 200])
def test_kernel_ragged_ray_counts(n_rays):
    """Ray counts that are not a multiple of the ray block are padded with
    dead rays and sliced back."""
    tris = _soup()
    o, d = _rays(tris, n_rays, seed=2)
    t1, i1 = intersect_jnp(jnp.asarray(o), jnp.asarray(d), tris)
    t2, i2 = _kernel(tris)(jnp.asarray(o), jnp.asarray(d))
    assert np.asarray(t2).shape == (n_rays,)
    assert np.asarray(i2).dtype == np.int32
    _check(tris, o, d, t1, i1, t2, i2, f"R={n_rays}")


@pytest.mark.parametrize("block", [(16, 16), (32, 64), (64, 32), (128, 128)])
def test_kernel_block_sizes(block):
    """Any power-of-two tile gives the same decisions (tiles only regroup
    the first-min reduction); the scene is padded to the triangle tile."""
    tris = _soup()
    o, d = _rays(tris, 256, seed=3)
    ref = _kernel(tris)(jnp.asarray(o), jnp.asarray(d))
    got = _kernel(tris, block_rays=block[0], block_tris=block[1])(
        jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(got[1]))
    np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(got[0]))


@pytest.mark.parametrize("bad", [True, 0, 48, "auto", 1.0])
def test_block_sizes_must_be_power_of_two_ints(bad):
    tris = _soup()
    o, d = _rays(tris, 4)
    with pytest.raises(ValueError):
        pallas_intersect(jnp.asarray(o), jnp.asarray(d), tris,
                         block_rays=bad, interpret=True)
    with pytest.raises(ValueError):
        make_pallas_intersect(tris, block_tris=bad, interpret=True)


def test_kernel_all_miss():
    """Rays pointing away from every triangle report (inf, -1)."""
    tris = flatten_scene(box_scene())
    v = np.asarray(tris.v0)[:tris.num_triangles]
    n = 70
    o = np.tile(v.max(0) + 5.0, (n, 1)).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    t, i = _kernel(tris)(jnp.asarray(o), jnp.asarray(d))
    assert (np.asarray(i) == -1).all()
    assert np.isinf(np.asarray(t)).all()


def test_kernel_tie_breaks_to_lowest_index():
    """Two identical triangles: the lower index wins, as in the reference's
    first-strict-min scan — across tiles too (the copy sits in a later
    triangle tile)."""
    vs = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    meshes = [HostMesh(vs, np.array([[0, 1, 2]], np.uint32))
              for _ in range(40)]
    tris = flatten_scene(HostScene(meshes))
    o = jnp.asarray([[0.0, 0.0, 2.0]] * 3, jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 3, jnp.float32)
    _, i = _kernel(tris, block_tris=16)(o, d)
    assert (np.asarray(i) == 0).all()
    _, i = _kernel(tris, block_tris=16)(
        o, d, exclude=jnp.asarray([0, 0, 5], jnp.int32))
    assert np.asarray(i).tolist() == [1, 1, 0]


@pytest.mark.parametrize("mode", ["nearest", "none"])
def test_kernel_exclude(mode):
    """Excluding each ray's nearest hit yields its second hit; excluding
    -1 changes nothing."""
    tris = _soup()
    o, d = _rays(tris, 300, seed=4)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    t0, i0 = intersect_jnp(oj, dj, tris)
    ex = i0 if mode == "nearest" else jnp.full((300,), -1, jnp.int32)
    t1, i1 = intersect_jnp(oj, dj, tris, exclude=ex)
    t2, i2 = _kernel(tris)(oj, dj, exclude=ex)
    _check(tris, o, d, t1, i1, t2, i2, f"exclude {mode}")
    if mode == "nearest":
        assert not np.any((np.asarray(i2) == np.asarray(i0))
                          & (np.asarray(i0) >= 0))


@pytest.mark.parametrize("kind", ["scalar", "per_ray"])
def test_kernel_t_max(kind):
    """``t_max`` keeps only hits with t <= t_max, like the jnp path's
    post-filter."""
    tris = _soup()
    o, d = _rays(tris, 300, seed=5)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    tm = (jnp.float32(4.0) if kind == "scalar" else jnp.asarray(
        np.random.default_rng(6).uniform(0, 10, 300), jnp.float32))
    t1, i1 = intersect_jnp(oj, dj, tris)
    within = np.asarray(t1) <= np.asarray(tm)
    t1 = np.where(within, np.asarray(t1), np.inf)
    i1 = np.where(within, np.asarray(i1), -1)
    t2, i2 = _kernel(tris)(oj, dj, t_max=tm)
    assert within.any() and not within.all()
    _check(tris, o, d, t1, i1, t2, i2, f"t_max {kind}")


@pytest.mark.parametrize("pattern", ["all_dead", "dead_blocks"])
def test_kernel_dead_blocks(pattern):
    """Blocks without a live ray skip the scan and report misses; live
    rays are unaffected by their neighbours' liveness."""
    tris = _soup()
    n = 8 * BR
    o, d = _rays(tris, n, seed=7)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    if pattern == "all_dead":
        live = np.zeros(n, bool)
    else:
        live = ((np.arange(n) // BR) % 2 == 0) & (np.arange(n) % 3 != 0)
    t_all, i_all = _kernel(tris)(oj, dj)
    t2, i2 = _kernel(tris)(oj, dj, live=jnp.asarray(live))
    i2 = np.asarray(i2)
    np.testing.assert_array_equal(i2[live], np.asarray(i_all)[live])
    dead_block = ~live.reshape(-1, BR).any(axis=1)
    assert (i2.reshape(-1, BR)[dead_block] == -1).all()


@pytest.mark.parametrize("kind", ["scalar", "per_ray"])
def test_kernel_any_hit(kind):
    """Any-hit queries agree with the nearest query on whether a hit within
    t_max exists, and every reported hit is a real one within t_max."""
    tris = _soup()
    o, d = _rays(tris, 320, seed=8)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    tm = (jnp.float32(6.0) if kind == "scalar" else jnp.asarray(
        np.random.default_rng(9).uniform(0, 12, 320), jnp.float32))
    t1, i1 = intersect_jnp(oj, dj, tris)
    blocked = (np.asarray(i1) >= 0) & (np.asarray(t1) <= np.asarray(tm))
    t2, i2 = _kernel(tris)(oj, dj, t_max=tm, any_hit=True)
    t2, i2 = np.asarray(t2), np.asarray(i2)
    np.testing.assert_array_equal(i2 >= 0, blocked)
    assert (t2[i2 >= 0] <= np.broadcast_to(np.asarray(tm), (320,))[
        i2 >= 0]).all()


@pytest.mark.parametrize("parity", ["reference", "physical"])
def test_kernel_trace_matches_jnp(parity, street_tris):
    """A full trace with the kernel (interpret mode) equals the jnp trace:
    the kernel's decisions feed the same differentiable shading."""
    kw = dict(num_paths=256, num_bounces=2, keep_rays=False, parity=parity,
              compact_rays=True)
    rx = np.array([[10.0, 5.0, 2.0]], np.float32)
    tx = np.array([[-20.0, -10.0, 10.0]], np.float32)
    z = np.zeros((1, 3), np.float32)
    mats = default_materials()
    ref = trace_paths(street_tris, mats, rx, tx, z, z, 3.0,
                      TracerConfig(backend="jnp", **kw))
    got = trace_paths(street_tris, mats, rx, tx, z, z, 3.0,
                      TracerConfig(**kw), intersect_fn=_kernel(street_tris))
    for f in ("a_te", "a_tm", "tau", "freq_shift"):
        np.testing.assert_array_equal(np.asarray(getattr(ref.scatter, f)),
                                      np.asarray(getattr(got.scatter, f)),
                                      err_msg=f)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu):
    """The kernel compiled for the card (not interpreted) against the jnp
    reference."""
    tris = _soup()
    o, d = _rays(tris, 1 << 14, seed=10)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    t1, i1 = intersect_jnp(oj, dj, tris)
    t2, i2 = pallas_intersect(oj, dj, tris)
    _check(tris, o, d, t1, i1, t2, i2, "gpu")
