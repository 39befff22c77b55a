"""Differentiability tests: gradients w.r.t. material parameters and TX/RX
positions checked against central finite differences of the forward pass
(BASELINE.json configs 2-3; SURVEY.md §7 M3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hermespy_rt_tpu as hrt
from hermespy_rt_tpu.config import TracerConfig
from hermespy_rt_tpu.materials import default_materials
from hermespy_rt_tpu.scene import flatten_scene, simple_reflector_scene, box_scene
from hermespy_rt_tpu.tracer import trace_paths

CFG = TracerConfig(num_paths=256, num_bounces=2, backend="jnp",
                   keep_rays=False)

RX = np.array([[0.1, -0.05, 0.4]], np.float32)
TX = np.array([[0.0, 0.1, 0.6]], np.float32)
Z = np.zeros((1, 3), np.float32)


def _loss_mats(mats, tris):
    res = trace_paths(tris, mats, RX, TX, Z, Z, 3.0, CFG)
    # power sum of scatter gains, scaled into a numerically comfy range
    return (jnp.sum(jnp.abs(res.scatter.a_te) ** 2)
            + jnp.sum(jnp.abs(res.scatter.a_tm) ** 2)) * 1e6


def _loss_pos(tx, tris, mats):
    res = trace_paths(tris, mats, RX, tx, Z, Z, 3.0, CFG)
    # distance-weighted observable: delay spread in metres + gain power
    c = 299792458.0
    return (jnp.sum(res.scatter.tau) * c
            + jnp.sum(jnp.abs(res.scatter.a_te) ** 2) * 1e6
            + jnp.sum(res.los.tau) * c)


@pytest.fixture(scope="module")
def reflector_tris():
    return flatten_scene(simple_reflector_scene())


def test_material_grads_vs_fd(reflector_tris):
    """Config 2: gradients w.r.t. material permittivity/conductivity (a, c)
    and roughness (s) on the reflector plate."""
    tris = reflector_tris
    mats = default_materials()
    grads = jax.grad(_loss_mats)(mats, tris)
    for field, eps in [("a", 0.05), ("c", 0.005), ("s", 0.01),
                       ("s1_alpha", 0.05), ("d", 0.01)]:
        g = np.asarray(getattr(grads, field))[1]  # concrete row
        base = np.asarray(getattr(mats, field)).copy()
        hi, lo = base.copy(), base.copy()
        hi[1] += eps
        lo[1] -= eps
        f_hi = float(_loss_mats(mats.replace(**{field: jnp.asarray(hi)}), tris))
        f_lo = float(_loss_mats(mats.replace(**{field: jnp.asarray(lo)}), tris))
        fd = (f_hi - f_lo) / (2 * eps)
        assert np.isfinite(g), field
        scale = max(abs(fd), abs(g), 1e-8)
        assert abs(g - fd) / scale < 0.05, (
            f"material.{field}: grad {g} vs fd {fd}")


def test_position_grads_vs_fd(reflector_tris):
    """Config 3 analogue: TX position gradients."""
    tris = reflector_tris
    mats = default_materials()
    g = np.asarray(jax.grad(_loss_pos)(jnp.asarray(TX), tris, mats))
    for axis in range(3):
        eps = 1e-3
        hi, lo = TX.copy(), TX.copy()
        hi[0, axis] += eps
        lo[0, axis] -= eps
        fd = (float(_loss_pos(jnp.asarray(hi), tris, mats))
              - float(_loss_pos(jnp.asarray(lo), tris, mats))) / (2 * eps)
        scale = max(abs(fd), abs(g[0, axis]), 1e-6)
        assert abs(g[0, axis] - fd) / scale < 0.05, (
            f"tx axis {axis}: grad {g[0, axis]} vs fd {fd}")


def test_grads_finite_everywhere_box():
    """No NaN/Inf gradients on a closed scene with deep bounces, TIR-prone
    angles and the full output set."""
    tris = flatten_scene(box_scene())
    mats = default_materials()
    cfg = TracerConfig(num_paths=128, num_bounces=3, backend="jnp",
                       keep_rays=False)
    rx = np.array([[1.0, 2.0, 1.5]], np.float32)
    tx = np.array([[-2.0, -1.0, 2.5]], np.float32)
    vel = np.array([[1.0, 0.5, -0.2]], np.float32)

    def loss(mats, tx_pos, rx_pos, tx_vel, rx_vel, f):
        res = trace_paths(tris, mats, rx_pos, tx_pos, rx_vel, tx_vel, f, cfg)
        return (jnp.sum(jnp.abs(res.scatter.a_te) ** 2) * 1e12
                + jnp.sum(jnp.abs(res.scatter.a_tm) ** 2) * 1e12
                + jnp.sum(res.scatter.tau) * 1e6
                + jnp.sum(res.scatter.freq_shift) * 1e-3
                + jnp.sum(jnp.abs(res.los.a_te) ** 2))

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5))(
        mats, jnp.asarray(tx), jnp.asarray(rx), jnp.asarray(vel),
        jnp.asarray(Z), jnp.float32(3.0))
    flat, _ = jax.tree.flatten(grads)
    for leaf in flat:
        assert np.all(np.isfinite(np.asarray(leaf))), "non-finite gradient"


def test_vertex_grads_flow():
    """Gradients flow into scene geometry (vertices via v0/e1/e2)."""
    tris = flatten_scene(simple_reflector_scene())
    mats = default_materials()

    def loss(v0):
        t2 = dataclasses.replace(tris, v0=v0)
        res = trace_paths(t2, mats, RX, TX, Z, Z, 3.0, CFG)
        return jnp.sum(res.scatter.tau) * 1e9

    g = np.asarray(jax.grad(loss)(tris.v0))
    assert np.all(np.isfinite(g))
    assert np.abs(g[:2]).sum() > 0  # the two real triangles get gradient
    assert np.abs(g[2:]).sum() == 0  # padding does not


def test_velocity_grads_vs_fd(reflector_tris):
    """FD check for TX/RX velocity gradients through the Doppler outputs
    (velocities, not only finiteness).
    Physical parity mode so per-index LoS velocities carry gradient."""
    tris = reflector_tris
    mats = default_materials()
    cfg = TracerConfig(num_paths=256, num_bounces=2, backend="jnp",
                       keep_rays=False, parity="physical")
    tx_vel0 = np.array([[3.0, -1.0, 0.5]], np.float32)
    rx_vel0 = np.array([[-0.5, 2.0, 1.0]], np.float32)

    def loss(tx_vel, rx_vel):
        res = trace_paths(tris, mats, RX, TX, rx_vel, tx_vel, 3.0, cfg)
        # freq_shift is linear in velocities; weight to keep O(1)
        return (jnp.sum(res.scatter.freq_shift) * 1e-1
                + jnp.sum(res.los.freq_shift) * 1e-1)

    g_tx, g_rx = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(tx_vel0), jnp.asarray(rx_vel0))
    g_tx, g_rx = np.asarray(g_tx), np.asarray(g_rx)
    eps = 1e-2
    for tag, base, g, argi in (("tx_vel", tx_vel0, g_tx, 0),
                               ("rx_vel", rx_vel0, g_rx, 1)):
        for axis in range(3):
            hi, lo = base.copy(), base.copy()
            hi[0, axis] += eps
            lo[0, axis] -= eps
            args_hi = [jnp.asarray(tx_vel0), jnp.asarray(rx_vel0)]
            args_lo = [jnp.asarray(tx_vel0), jnp.asarray(rx_vel0)]
            args_hi[argi] = jnp.asarray(hi)
            args_lo[argi] = jnp.asarray(lo)
            fd = (float(loss(*args_hi)) - float(loss(*args_lo))) / (2 * eps)
            scale = max(abs(fd), abs(g[0, axis]), 1e-6)
            assert abs(g[0, axis] - fd) / scale < 0.02, (
                f"{tag} axis {axis}: grad {g[0, axis]} vs fd {fd}")
    # Doppler must actually depend on the velocities (non-degenerate check)
    assert np.abs(g_tx).sum() > 0 and np.abs(g_rx).sum() > 0


def test_mesh_velocity_grads_vs_fd(reflector_tris):
    """FD check for scene (mesh) velocity gradients through the reflection
    and scattered-leg Doppler accumulation."""
    tris = reflector_tris
    mats = default_materials()
    cfg = TracerConfig(num_paths=256, num_bounces=2, backend="jnp",
                       keep_rays=False)

    def loss(vel):
        t2 = dataclasses.replace(tris, velocity=jnp.broadcast_to(
            vel, tris.velocity.shape))
        res = trace_paths(t2, mats, RX, TX, Z, Z, 3.0, cfg)
        return jnp.sum(res.scatter.freq_shift) * 1e-1

    v0 = jnp.asarray([2.0, -1.0, 0.3], jnp.float32)
    g = np.asarray(jax.grad(loss)(v0))
    eps = 1e-2
    for axis in range(3):
        hi = np.asarray(v0).copy(); hi[axis] += eps
        lo = np.asarray(v0).copy(); lo[axis] -= eps
        fd = (float(loss(jnp.asarray(hi))) - float(loss(jnp.asarray(lo)))) / (2 * eps)
        scale = max(abs(fd), abs(g[axis]), 1e-6)
        assert abs(g[axis] - fd) / scale < 0.02, (
            f"mesh vel axis {axis}: grad {g[axis]} vs fd {fd}")
    assert np.abs(g).sum() > 0


def test_carrier_frequency_grads_vs_fd(reflector_tris):
    """FD check for the carrier-frequency gradient.
    f enters the Friis clamps, the ITU eta power laws and the Doppler
    multiplier; checked away from the max(1, .) clamp corners."""
    tris = reflector_tris
    mats = default_materials()
    cfg = TracerConfig(num_paths=256, num_bounces=2, backend="jnp",
                       keep_rays=False)
    vel = np.array([[1.0, 0.0, 0.0]], np.float32)

    def loss(f_ghz):
        res = trace_paths(tris, mats, RX, TX, Z, jnp.asarray(vel), f_ghz,
                          cfg)
        return (jnp.sum(jnp.abs(res.scatter.a_te) ** 2) * 1e6
                + jnp.sum(res.scatter.freq_shift) * 1e-6)

    f0 = jnp.float32(3.0)
    g = float(jax.grad(loss)(f0))
    eps = 1e-3
    fd = (float(loss(jnp.float32(3.0 + eps)))
          - float(loss(jnp.float32(3.0 - eps)))) / (2 * eps)
    scale = max(abs(fd), abs(g), 1e-8)
    assert np.isfinite(g)
    assert abs(g - fd) / scale < 0.05, f"f_ghz: grad {g} vs fd {fd}"
    assert abs(g) > 0


def test_grad_geometry_false_material_grads_identical(reflector_tris):
    """grad_geometry=False must produce BIT-IDENTICAL material gradients
    (the eta chain never passes through geometry; stop-gradding the
    geometric payload only lets XLA DCE the cross-bounce backward), while
    zeroing vertex gradients."""
    tris = reflector_tris
    mats = default_materials()
    cfg_ng = dataclasses.replace(CFG, grad_geometry=False)

    def loss(m, cfg):
        res = trace_paths(tris, m, RX, TX, Z, Z, 3.0, cfg)
        return (jnp.sum(jnp.abs(res.scatter.a_te) ** 2)
                + jnp.sum(jnp.abs(res.scatter.a_tm) ** 2)) * 1e6

    v1, g1 = jax.value_and_grad(loss)(mats, CFG)
    v2, g2 = jax.value_and_grad(loss)(mats, cfg_ng)
    assert float(v1) == float(v2)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # vertex gradients are zeroed (documented trade) under grad_geometry=False
    def loss_v(v0):
        t2 = dataclasses.replace(tris, v0=v0)
        res = trace_paths(t2, mats, RX, TX, Z, Z, 3.0, cfg_ng)
        return jnp.sum(jnp.abs(res.scatter.a_te) ** 2) * 1e6

    gv = jax.grad(loss_v)(tris.v0)
    assert not np.asarray(gv).any()
