"""ops/fetch.py: the one-pass limb one-hot fetch must be bit-exact vs a plain
gather, in both the forward row select and the backward scatter-add."""
import jax
import jax.numpy as jnp
import numpy as np

from hermespy_rt_tpu.ops.fetch import onehot_fetch, take_fetch


def _table(t=37, c=27, seed=0):
    rng = np.random.default_rng(seed)
    # mix of scales: unit geometry, large eta_abs_pow2-like values, tiny limbs
    vals = rng.standard_normal((t, c)).astype(np.float32)
    vals[:, :5] *= 1e4
    vals[:, 5:9] *= 1e-6
    return jnp.asarray(vals)


def test_forward_bit_exact_1d():
    table = _table()
    idx = jnp.asarray(np.random.default_rng(1).integers(0, 37, size=257),
                      jnp.int32)
    got = onehot_fetch(idx, table)
    want = take_fetch(idx, table)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_forward_bit_exact_2d_leading():
    table = _table(t=64, c=12, seed=2)
    idx = jnp.asarray(np.random.default_rng(3).integers(0, 64, size=(4, 33)),
                      jnp.int32)
    got = onehot_fetch(idx, table)
    want = take_fetch(idx, table)
    assert got.shape == (4, 33, 12)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_backward_bit_exact_scatter_add():
    table = _table(t=16, c=8, seed=4)
    idx = jnp.asarray(np.random.default_rng(5).integers(0, 16, size=100),
                      jnp.int32)
    w = jnp.asarray(np.random.default_rng(6)
                    .standard_normal((100, 8)).astype(np.float32))

    def loss_onehot(tab):
        return jnp.sum(onehot_fetch(idx, tab) * w)

    def loss_take(tab):
        return jnp.sum(take_fetch(idx, tab) * w)

    g1 = jax.grad(loss_onehot)(table)
    g2 = jax.grad(loss_take)(table)
    # each dtable entry is a sum over the rays that selected that row; both
    # paths accumulate in f32 — but in different orders, so allow 1-ulp-ish
    # slack while requiring effectively identical values
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=1e-6, atol=1e-6)


def test_under_jit_and_vjp_nondiff_idx():
    table = _table(t=8, c=4, seed=7)
    idx = jnp.asarray([0, 3, 7, 3], jnp.int32)

    @jax.jit
    def f(tab):
        return jnp.sum(onehot_fetch(idx, tab) ** 2)

    v, g = jax.value_and_grad(f)(table)
    assert np.isfinite(float(v))
    assert g.shape == table.shape


def test_tracer_gather_variants_agree():
    """Both gather strategies give identical traces, with the intersection
    kernel in interpret mode."""
    from hermespy_rt_tpu.config import TracerConfig
    from hermespy_rt_tpu.materials import default_materials
    from hermespy_rt_tpu.ops.intersect_pallas import make_pallas_intersect
    from hermespy_rt_tpu.scene import flatten_scene, box_scene
    from hermespy_rt_tpu.tracer import trace_paths
    tris = flatten_scene(box_scene())
    mats = default_materials()
    rx = jnp.asarray([[1.0, 2.0, 1.5]])
    tx = jnp.asarray([[-2.0, -1.0, 2.5]])
    z = jnp.zeros((1, 3))
    kernel = make_pallas_intersect(tris, interpret=True)
    outs = []
    for gather in ("take", "onehot"):
        cfg = TracerConfig(num_paths=128, num_bounces=2, keep_rays=False,
                           gather=gather)
        r = trace_paths(tris, mats, rx, tx, z, z, jnp.float32(3.0), cfg,
                        intersect_fn=kernel)
        outs.append(np.asarray(r.scatter.a_te))
    np.testing.assert_array_equal(outs[0], outs[1])
