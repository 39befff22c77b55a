"""Golden parity tests: the JAX tracer vs the compiled C reference on the
four shipped scenes (SURVEY.md §4 test plan).

Comparison rules follow the reference defect catalogue (SURVEY.md §3.5):
* scatter ``directions_tx`` is never written by the reference -> not compared
  (our framework populates it as a documented improvement);
* scatter ``freq_shift`` parity only holds for single-TX configs with zero
  mesh velocities (the reference's buffer layouts alias otherwise);
* LoS directions are only defined for unblocked pairs;
* a tiny fraction of rays may flip hit decisions at f32 triangle edges.
"""
import numpy as np
import pytest

import hermespy_rt_tpu as hrt
from tests.oracle.oracle import run_reference
from tests.utils import assert_mostly_allclose, ref_scene_path

Z1 = np.zeros((1, 3), np.float32)


def run_both(scene_name, rx, tx, rxv=None, txv=None, f=3.0, P=1000, B=3,
             **cfg_kw):
    path = ref_scene_path(scene_name)
    rx = np.asarray(rx, np.float32).reshape(-1, 3)
    tx = np.asarray(tx, np.float32).reshape(-1, 3)
    rxv = np.zeros_like(rx) if rxv is None else np.asarray(rxv, np.float32).reshape(-1, 3)
    txv = np.zeros_like(tx) if txv is None else np.asarray(txv, np.float32).reshape(-1, 3)
    ref = run_reference(path, rx, tx, rxv, txv, f, P, B)
    los, scat = hrt.compute_paths(path, rx, tx, rxv, txv, f,
                                  rx.shape[0], tx.shape[0], P, B,
                                  backend="jnp", **cfg_kw)
    return ref, los, scat


def check_scatter(ref, scat, rtol=5e-5, max_bad_frac=0.002, freq=False):
    a_ref = ref.scatter.a_te
    a_us = np.asarray(scat.a_te)
    # XLA flushes float32 denormals to zero; the C reference keeps them.
    # Gains below ~1e-37 (< -700 dB) are physically meaningless — treat them
    # as zero on both sides for mask comparison.
    tiny = 1e-37
    nz_ref = np.abs(a_ref) > tiny
    nz_us = np.abs(a_us) > tiny
    assert (nz_ref == nz_us).mean() > 1 - max_bad_frac, "hit/blocked masks differ"
    m = nz_ref & nz_us
    scale = max(np.abs(a_ref[m]).max(), 1e-30) if m.any() else 1.0
    assert_mostly_allclose(a_ref[m], a_us[m], rtol=rtol,
                           atol=rtol * scale, max_bad_frac=max_bad_frac,
                           label="scatter.a_te")
    assert_mostly_allclose(ref.scatter.a_tm[m], np.asarray(scat.a_tm)[m],
                           rtol=rtol, atol=rtol * scale,
                           max_bad_frac=max_bad_frac, label="scatter.a_tm")
    assert_mostly_allclose(ref.scatter.tau[m], np.asarray(scat.tau)[m],
                           rtol=1e-5, atol=1e-12, max_bad_frac=max_bad_frac,
                           label="scatter.tau")
    assert_mostly_allclose(ref.scatter.directions_rx[m],
                           np.asarray(scat.directions_rx)[m],
                           rtol=1e-4, atol=1e-5, max_bad_frac=max_bad_frac,
                           label="scatter.directions_rx")
    if freq:
        assert_mostly_allclose(ref.scatter.freq_shift, np.asarray(scat.freq_shift),
                               rtol=1e-4, atol=1e-2,
                               max_bad_frac=max_bad_frac,
                               label="scatter.freq_shift")


def check_los(ref, los, freq=True):
    act = ref.los_active.reshape(ref.los.tau.shape[:2])
    np.testing.assert_allclose(ref.los.a_te, np.asarray(los.a_te), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(ref.los.a_tm, np.asarray(los.a_tm), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(ref.los.tau, np.asarray(los.tau), rtol=1e-6,
                               atol=1e-18)
    m = act  # directions only defined where unblocked
    np.testing.assert_allclose(ref.los.directions_rx[m],
                               np.asarray(los.directions_rx)[m],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref.los.directions_tx[m],
                               np.asarray(los.directions_tx)[m],
                               rtol=1e-5, atol=1e-6)
    if freq:
        np.testing.assert_allclose(ref.los.freq_shift, np.asarray(los.freq_shift),
                                   rtol=1e-4, atol=1e-3)


def test_simple_reflector_parity():
    ref, los, scat = run_both("simple_reflector.hrt",
                              [[0, 0, 0.15]], [[0, 0, 0.151]], P=2000, B=3)
    check_los(ref, los)
    check_scatter(ref, scat, freq=True)


def test_box_parity_depth2():
    # BASELINE.json config 1: single TX/RX in a box, depth-2 paths.
    ref, los, scat = run_both("box.hrt", [[1.0, 2.0, 1.5]], [[-2.0, -1.0, 2.5]],
                              P=2000, B=2)
    check_los(ref, los)
    check_scatter(ref, scat, freq=True)


def test_box_parity_depth4_offcenter():
    ref, los, scat = run_both("box.hrt", [[4.0, -3.0, 0.5]], [[-4.5, 4.0, 4.5]],
                              P=1500, B=4, f=28.0)
    check_los(ref, los)
    check_scatter(ref, scat)


def test_2cars_parity_depth3():
    # BASELINE.json config 3 geometry (test/2cars.c intent: 70 GHz).
    ref, los, scat = run_both("2cars.hrt", [[5.0, 2.0, 1.0]], [[-5.0, -2.0, 1.5]],
                              P=2000, B=3, f=70.0)
    check_los(ref, los)
    check_scatter(ref, scat)


def test_street_canyon_parity():
    # BASELINE.json config 4 scene.
    ref, los, scat = run_both("simple_street_canyon_with_cars.hrt",
                              [[10.0, 5.0, 2.0]], [[-20.0, -10.0, 10.0]],
                              P=2000, B=3)
    check_los(ref, los)
    check_scatter(ref, scat)


def test_multi_rx_tx_parity():
    rx = [[0, 0, 0.15], [0.2, 0.1, 0.3], [-0.3, 0.2, 0.5]]
    tx = [[0, 0, 0.151], [0.1, -0.2, 0.4]]
    ref, los, scat = run_both("simple_reflector.hrt", rx, tx, P=500, B=2)
    check_los(ref, los, freq=False)
    check_scatter(ref, scat)


def test_doppler_parity_single_link():
    # T=1/R=1 with TX/RX velocities and static meshes: the reference's Doppler
    # buffers are self-consistent in this configuration (SURVEY.md §3.5 2).
    ref, los, scat = run_both("simple_reflector.hrt",
                              [[0, 0, 0.15]], [[0, 0, 0.151]],
                              rxv=[[1.0, 2.0, -0.5]], txv=[[-3.0, 0.5, 2.0]],
                              P=500, B=3)
    check_los(ref, los, freq=True)
    check_scatter(ref, scat, freq=True)


def test_los_blocked_and_coincident():
    # TX below the reflector plate, RX above: LoS blocked, gains 0.
    ref, los, _ = run_both("simple_reflector.hrt",
                           [[0, 0, 1.0]], [[0, 0, -1.0]], P=100, B=1)
    assert not ref.los_active[0]
    assert abs(np.asarray(los.a_te))[0, 0, 0] == 0.0
    np.testing.assert_allclose(ref.los.a_te, np.asarray(los.a_te))
    # coincident TX == RX -> unit gain, zero delay
    ref2, los2, _ = run_both("simple_reflector.hrt",
                             [[0, 0, 0.25]], [[0, 0, 0.25]], P=100, B=1)
    np.testing.assert_allclose(np.asarray(los2.a_te)[0, 0, 0], 1.0)
    np.testing.assert_allclose(ref2.los.a_te[0, 0, 0], 1.0)
    assert float(np.asarray(los2.tau)[0, 0, 0]) == 0.0


def test_rays_info_parity_single_tx():
    P, B = 500, 3
    path = ref_scene_path("box.hrt")
    rx = np.array([[1.0, 2.0, 1.5]], np.float32)
    tx = np.array([[-2.0, -1.0, 2.5]], np.float32)
    ref = run_reference(path, rx, tx, Z1, Z1, 3.0, P, B)
    res = hrt.trace(path, rx, tx, carrier_frequency=3.0,
                    config=hrt.TracerConfig(num_paths=P, num_bounces=B,
                                            backend="jnp"))
    ri = res.rays_scatter
    ours_o = np.asarray(ri.origins)[0]      # [B+1, P, 3]
    ours_d = np.asarray(ri.directions)[0]
    ref_rays = ref.scat_rays.reshape(-1, P, 6)  # slot-major (tx=0)
    for slot in range(B + 1):
        ro, rd = ref_rays[slot, :, :3], ref_rays[slot, :, 3:]
        if slot == 0:
            np.testing.assert_allclose(ro, ours_o[0], atol=1e-6)
            np.testing.assert_allclose(rd, ours_d[0], atol=1e-6)
        else:
            # only rays still active at that bounce have defined state
            act = np.asarray(ri.active)[0, slot]
            assert_mostly_allclose(ro[act], ours_o[slot][act], rtol=1e-4,
                                   atol=1e-4, max_bad_frac=0.01,
                                   label=f"rays o slot {slot}")
            assert_mostly_allclose(rd[act], ours_d[slot][act], rtol=1e-4,
                                   atol=1e-4, max_bad_frac=0.01,
                                   label=f"rays d slot {slot}")
    # active bitmask parity (layout per /root/reference/src/compute_paths.c:733)
    stride = P // 8 + 1
    for slot in range(1, B + 1):
        chunk = ref.scat_active_bits[slot * stride:(slot + 1) * stride]
        bits = np.unpackbits(chunk, bitorder="little").astype(bool)
        n = min(P, bits.size)  # reference under-sizes the last slot (§3.5 3)
        ours = np.asarray(ri.active)[0, slot][:n]
        assert (bits[:n] == ours).mean() > 0.995


def test_physical_mode_runs():
    # "physical" parity mode: distance-correct occlusion; just check it runs
    # and produces at least as many unblocked scatter paths as reference mode.
    path = ref_scene_path("box.hrt")
    rx = [[1.0, 2.0, 1.5]]
    tx = [[-2.0, -1.0, 2.5]]
    _, scat_ref = hrt.compute_paths(path, rx, tx, Z1, Z1, 3.0, 1, 1, 500, 2,
                                    backend="jnp", parity="reference")
    _, scat_phy = hrt.compute_paths(path, rx, tx, Z1, Z1, 3.0, 1, 1, 500, 2,
                                    backend="jnp", parity="physical")
    nz_ref = int((np.abs(np.asarray(scat_ref.a_te)) > 0).sum())
    nz_phy = int((np.abs(np.asarray(scat_phy.a_te)) > 0).sum())
    assert nz_phy > 0
    # in a closed box every in-box shadow ray within 1 m is the same set or
    # fewer than distance-correct blocking
    assert nz_phy <= nz_ref


def test_canyon_parity_flips_are_marginal():
    """Flip taxonomy for the oracle comparison: slots
    where we and the C reference disagree on the hit/blocked mask must be
    provably marginal — the ray chain that produced them involves an f64
    Möller–Trumbore quantity within epsilon of a decision boundary (a
    barycentric edge, the t<=1 occlusion window, or a near-tie nearest hit).

    Reconstructed from our own RaysInfo: slot (rx, b, p) flips only if the
    bounce-b hit decision or the (b, rx) shadow occlusion was marginal at
    some depth <= b."""
    from tests.utils import _mt_f64
    from hermespy_rt_tpu.scene import load_hrt, flatten_scene

    P, B = 2000, 3
    rx = [[10.0, 5.0, 2.0]]
    tx = [[-20.0, -10.0, 10.0]]
    path = ref_scene_path("simple_street_canyon_with_cars.hrt")
    z = np.zeros((1, 3), np.float32)
    ref = run_reference(path, np.asarray(rx, np.float32),
                        np.asarray(tx, np.float32), z, z, 3.0, P, B)
    res = hrt.trace(path, rx, tx, config=hrt.TracerConfig(
        num_paths=P, num_bounces=B, backend="jnp", keep_rays=True))
    scat = res.scatter
    tiny = 1e-37
    nz_ref = np.abs(ref.scatter.a_te) > tiny
    nz_us = np.abs(np.asarray(scat.a_te)) > tiny
    flips = (nz_ref != nz_us)[0, 0]          # [B*P]
    if not flips.any():
        return
    tris = flatten_scene(load_hrt(path))
    rays = res.rays_scatter                   # origins [NTx, B+1, P, 3]
    margin = 2e-4

    def marginal(o, d, window=None):
        """Any f64 MT quantity within margin of a decision boundary?"""
        det, u, v, t = _mt_f64(tris, o[None], d[None])
        det, u, v, t = det[0], u[0], v[0], t[0]
        near_edge = (np.abs(u) < margin) | (np.abs(u - 1) < margin) | \
                    (np.abs(v) < margin) | (np.abs(u + v - 1) < margin) | \
                    (np.abs(det) < 1e-5)
        inside = (u > -margin) & (v > -margin) & (u + v < 1 + margin) & \
                 (t > 0)
        cand = inside & (t > 0)
        if window is not None:
            near_window = cand & (np.abs(t - window) < margin * window)
            if near_window.any():
                return True
        if (near_edge & inside).any():
            return True
        # near-tie nearest hits
        valid = (u > margin) & (v > margin) & (u + v < 1 - margin) & (t > 1e-7)
        if window is not None:
            valid &= t <= window
        ts = np.sort(t[valid])
        return len(ts) >= 2 and (ts[1] - ts[0]) < margin * max(ts[0], 1e-9)

    rxp = np.asarray(rx[0], np.float64)
    unexplained = []
    for slot in np.where(flips)[0]:
        b, p = divmod(int(slot), P)
        ok = False
        for bb in range(b + 1):
            o_b = np.asarray(rays.origins[0, bb, p], np.float64)
            d_b = np.asarray(rays.directions[0, bb, p], np.float64)
            if marginal(o_b, d_b):           # bounce-hit decision marginal
                ok = True
                break
        if not ok:
            o_s = np.asarray(rays.origins[0, b + 1, p], np.float64)
            ds = rxp - o_s
            ds /= np.linalg.norm(ds)
            ok = marginal(o_s, ds, window=1.0)   # shadow 1m-window marginal
        if not ok:
            unexplained.append(int(slot))
    assert not unexplained, (
        f"{len(unexplained)}/{flips.sum()} parity mask flips are not "
        f"provably marginal: slots {unexplained[:10]}")
