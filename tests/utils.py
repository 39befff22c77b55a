"""Shared test helpers."""
from __future__ import annotations

import os

import numpy as np
import pytest

# the reference checkout: $HERMESPY_RT_REFERENCE, else the gitignored
# "reference" directory inside this checkout
REF_DIR = os.environ.get("HERMESPY_RT_REFERENCE", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "reference"))


def ref_path(*parts: str) -> str:
    """Path inside the reference checkout; skips the calling test when the
    checkout (or that part of it) is not present."""
    path = os.path.join(REF_DIR, *parts)
    if not os.path.exists(path):
        pytest.skip(f"reference checkout lacks {os.path.join(*parts)}")
    return path


def ref_scene_path(name: str) -> str:
    return ref_path("scenes", name)


def assert_mostly_allclose(ref, us, rtol=1e-4, atol=0.0, max_bad_frac=0.0,
                           label=""):
    """Allclose that tolerates a tiny fraction of boundary-divergent slots.

    Float32 intersection decisions at triangle edges can legitimately differ
    between the C scan and the vectorised reduction by 1 ulp, flipping the
    entire output of that ray; ``max_bad_frac`` bounds how many slots may
    disagree while everything else must match to ``rtol/atol``.
    NaNs in ``ref`` (the reference's uninitialised/acos>1 slots) are excluded.
    """
    ref = np.asarray(ref)
    us = np.asarray(us)
    assert ref.shape == us.shape, f"{label}: shape {ref.shape} vs {us.shape}"
    finite = np.isfinite(ref) if np.issubdtype(ref.dtype, np.floating) else (
        np.isfinite(ref.real) & np.isfinite(ref.imag))
    err = np.abs(ref - us)
    tol = atol + rtol * np.abs(ref)
    ok = (err <= tol) | ~finite
    bad_frac = 1.0 - ok.mean()
    assert bad_frac <= max_bad_frac + 1e-12, (
        f"{label}: {bad_frac:.2%} of slots disagree (> {max_bad_frac:.2%}); "
        f"worst err {err[finite].max() if finite.any() else 0}")


def _mt_f64(tris, o, d, idx=None):
    """Möller–Trumbore quantities in float64 for rays x (one triangle per ray
    if idx given, else all triangles).  Returns (det, u, v, t) arrays."""
    v0 = np.asarray(tris.v0, np.float64)
    e1 = np.asarray(tris.e1, np.float64)
    e2 = np.asarray(tris.e2, np.float64)
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    if idx is not None:
        sel = np.maximum(np.asarray(idx), 0)
        v0, e1, e2 = v0[sel], e1[sel], e2[sel]
        pv = np.cross(d, e2)
        det = np.sum(e1 * pv, -1)
        s = o - v0
        qv = np.cross(s, e1)
    else:
        pv = np.cross(d[:, None, :], e2[None])
        det = np.sum(e1[None] * pv, -1)
        s = o[:, None, :] - v0[None]
        qv = np.cross(s, e1[None])
        d = d[:, None, :]
    det_s = np.where(det == 0, 1e-300, det)
    u = np.sum(s * pv, -1) / det_s
    v = np.sum(d * qv, -1) / det_s
    t = np.sum((e2[None] if idx is None else e2) * qv, -1) / det_s
    return det, u, v, t


def edge_distance_f64(tris, o, d, idx):
    """Barycentric edge distance min(u, v, 1-u-v) of the given hits, f64."""
    _, u, v, _ = _mt_f64(tris, o, d, idx=idx)
    return np.minimum(np.minimum(u, v), 1.0 - u - v)


def assert_flips_explained(tris, o, d, t1, i1, t2, i2, t_rtol=1e-5,
                           edge_eps=1e-4, label=""):
    """Flip taxonomy: every ray where two kernels
    disagree on the hit index must be a provable epsilon-edge case —

      (a) both hit, with near-equal t (an exact-tie in f32 terms), or
      (b) either side's winning hit lies within ``edge_eps`` of a
          barycentric edge (u, v or 1-u-v ~ 0) in float64, or
      (c) a hit<->miss flip whose hit side is edge-marginal per (b).

    Raises with the unexplained rays otherwise."""
    t1, i1, t2, i2 = map(np.asarray, (t1, i1, t2, i2))
    flips = i1 != i2
    if not flips.any():
        return 0
    idxs = np.where(flips)[0]
    of, df = np.asarray(o)[idxs], np.asarray(d)[idxs]
    tie = np.zeros(len(idxs), bool)
    both = (i1[idxs] >= 0) & (i2[idxs] >= 0)
    tie[both] = (np.abs(t1[idxs][both] - t2[idxs][both])
                 <= t_rtol * np.maximum(np.abs(t1[idxs][both]), 1e-12))
    edge = np.zeros(len(idxs), bool)
    for ii in (i1, i2):
        hit = ii[idxs] >= 0
        if hit.any():
            ed = edge_distance_f64(tris, of[hit], df[hit], ii[idxs][hit])
            e = np.zeros(len(idxs), bool)
            e[hit] = np.abs(ed) <= edge_eps
            edge |= e
    unexplained = ~(tie | edge)
    assert not unexplained.any(), (
        f"{label}: {unexplained.sum()} of {len(idxs)} kernel flips are NOT "
        f"edge/tie cases; first ray {idxs[unexplained][0]} "
        f"(i1={i1[idxs[unexplained][0]]}, i2={i2[idxs[unexplained][0]]})")
    return len(idxs)
