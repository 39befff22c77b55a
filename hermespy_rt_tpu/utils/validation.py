"""Input validation and numeric failure detection.

The reference's only error handling is ``perror`` + ``exit``
(/root/reference/inc/common.h:20-25, SURVEY.md §5); here scenes and tracer
inputs are validated host-side *before* device dispatch and return structured
errors, and traced outputs can be audited for NaN/Inf contamination (the
SPMD analogue of a sanitizer — there are no shared-memory races in SPMD array code).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..materials import NUM_MATERIALS
from ..scene.model import HostScene

__all__ = ["validate_scene", "validate_inputs", "check_finite",
           "SceneValidationError"]


class SceneValidationError(ValueError):
    pass


def validate_scene(scene: HostScene, max_meshes: int = 1000,
                   strict_materials: bool = False) -> List[str]:
    """Validate a host scene; raises on hard errors, returns soft warnings.

    Hard limits mirror the reference loader caps
    (/root/reference/src/scene.c:52-55).
    """
    if scene.num_meshes == 0:
        raise SceneValidationError("scene has no meshes")
    if scene.num_meshes > max_meshes:
        raise SceneValidationError(
            f"scene has too many meshes ({scene.num_meshes} > {max_meshes})")
    warnings = []
    for i, m in enumerate(scene.meshes):
        name = m.name or f"mesh[{i}]"
        if m.num_triangles == 0:
            warnings.append(f"{name}: no triangles")
            continue
        if m.indices.size and int(m.indices.max()) >= m.num_vertices:
            raise SceneValidationError(
                f"{name}: triangle index {int(m.indices.max())} out of range "
                f"(num_vertices={m.num_vertices})")
        if not np.isfinite(m.vertices).all():
            raise SceneValidationError(f"{name}: non-finite vertex coordinates")
        if m.material_index >= NUM_MATERIALS:
            msg = (f"{name}: material index {m.material_index} outside the "
                   f"builtin table (0..{NUM_MATERIALS - 1})")
            if strict_materials:
                raise SceneValidationError(msg)
            warnings.append(msg)
        # degenerate triangles never intersect but waste kernel work
        tri = m.vertices[m.indices.astype(np.int64)]
        area2 = np.linalg.norm(
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
        ndeg = int((area2 <= 0).sum())
        if ndeg:
            warnings.append(f"{name}: {ndeg} degenerate (zero-area) triangles")
    return warnings


def validate_inputs(rx_pos, tx_pos, rx_vel, tx_vel, carrier_frequency_ghz):
    """Tracer input sanity (finite, shape-consistent, f > 0 as the reference's
    contract states, /root/reference/inc/compute_paths.h:64)."""
    for name, arr in (("rx_positions", rx_pos), ("tx_positions", tx_pos),
                      ("rx_velocities", rx_vel), ("tx_velocities", tx_vel)):
        a = np.asarray(arr, np.float32)
        if a.ndim != 2 or a.shape[-1] != 3:
            raise ValueError(f"{name} must have shape (N, 3), got {a.shape}")
        if not np.isfinite(a).all():
            raise ValueError(f"{name} contains non-finite values")
    if not (float(carrier_frequency_ghz) > 0.0):
        raise ValueError("carrier_frequency must be > 0 GHz")
    if np.asarray(rx_pos).shape[0] != np.asarray(rx_vel).shape[0]:
        raise ValueError("rx_positions and rx_velocities row counts differ")
    if np.asarray(tx_pos).shape[0] != np.asarray(tx_vel).shape[0]:
        raise ValueError("tx_positions and tx_velocities row counts differ")


def check_finite(result, raise_on_fail: bool = True) -> List[str]:
    """Audit a PathsResult for NaN/Inf in every output array."""
    import jax
    bad = []
    for name, leaf in zip(
            ("los", "scatter"), (result.los, result.scatter)):
        for field in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx",
                      "directions_tx"):
            x = np.asarray(getattr(leaf, field))
            arr = np.concatenate([x.real.ravel(), x.imag.ravel()]) \
                if np.iscomplexobj(x) else x.ravel()
            n = int((~np.isfinite(arr)).sum())
            if n:
                bad.append(f"{name}.{field}: {n} non-finite values")
    del jax
    if bad and raise_on_fail:
        raise FloatingPointError("; ".join(bad))
    return bad
