"""RX-chunked shadow queries must bit-match the single batched query.

The scatter pass batches all NRx * num_paths shadow rays into one
nearest-hit call; above ``TracerConfig.rx_query_rays`` the call is split
into RX groups run sequentially under ``lax.map``
(``hermespy_rt_tpu.tracer._shadow_intersect``).  The chunked branch only
activates above 4M shadow rays in production, so this pins it at a tiny
threshold.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from hermespy_rt_tpu.config import TracerConfig
from hermespy_rt_tpu.materials import default_materials
from hermespy_rt_tpu.scene import flatten_scene, load_hrt
from hermespy_rt_tpu.tracer import LocalSceneAccess, _shadow_intersect, \
    trace_paths
from tests.utils import ref_scene_path


@pytest.fixture(scope="module")
def tris():
    return flatten_scene(load_hrt(ref_scene_path("2cars.hrt")))


def _rays(rng, nrx, R):
    so = np.repeat(rng.uniform(-8, 8, (1, R, 3)), nrx, axis=0)
    rx = rng.uniform(-10, 10, (nrx, 1, 3))
    ds = rx - so
    ds /= np.linalg.norm(ds, axis=-1, keepdims=True)
    return jnp.asarray(so, jnp.float32), jnp.asarray(ds, jnp.float32)


@pytest.mark.parametrize("with_tmax", [False, True])
@pytest.mark.parametrize("with_excl", [False, True])
def test_chunked_matches_batched(rng, tris, with_tmax, with_excl):
    nrx, R = 4, 256
    so, ds = _rays(rng, nrx, R)
    t_max = (jnp.asarray(rng.uniform(1.0, 30.0, nrx * R), jnp.float32)
             if with_tmax else None)
    excl = (jnp.asarray(rng.integers(-1, tris.num_triangles, nrx * R),
                        jnp.int32) if with_excl else None)

    batched = LocalSceneAccess(tris, cfg=TracerConfig(backend="jnp"))
    t0, i0 = _shadow_intersect(batched, so, ds, t_max, excl,
                               TracerConfig(backend="jnp"))
    # rx_query_rays below R forces per-RX groups (c == 1); an intermediate
    # value exercises a 2-RX grouping
    for cap in (R, 2 * R):
        t1, i1 = _shadow_intersect(batched, so, ds, t_max, excl,
                                   TracerConfig(backend="jnp",
                                                rx_query_rays=cap))
        np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


def test_chunked_trace_end_to_end(rng, tris):
    """A full trace with a tiny rx_query_rays bit-matches the default."""
    mats = default_materials()
    rx = jnp.asarray(rng.uniform(-6, 6, (3, 3)), jnp.float32)
    tx = jnp.asarray([[0.0, 0.0, 4.0]], jnp.float32)
    z3, z1 = jnp.zeros((3, 3), jnp.float32), jnp.zeros((1, 3), jnp.float32)
    out = []
    for cap in (1 << 22, 64):
        cfg = TracerConfig(num_paths=128, num_bounces=2, backend="jnp",
                           keep_rays=False, rx_query_rays=cap)
        r = trace_paths(tris, mats, rx, tx, z3, z1, jnp.float32(3.0), cfg)
        out.append(r)
    for field in ("a_te", "a_tm", "tau", "freq_shift"):
        a = np.asarray(getattr(out[0].scatter, field).real)
        b = np.asarray(getattr(out[1].scatter, field).real)
        np.testing.assert_array_equal(a, b)


def test_rx_query_rays_validated():
    with pytest.raises(ValueError):
        TracerConfig(rx_query_rays=0)
