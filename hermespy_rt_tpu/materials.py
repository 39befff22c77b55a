"""ITU-R P.2040-3 radio-material database as a differentiable JAX pytree.

Capability parity with the reference materials subsystem
(``/root/reference/src/materials.c:3-122``, ``/root/reference/inc/materials.h:12-30``,
``/root/reference/inc/scene.h:34-66``): 17 named materials, each carrying the ITU
frequency power-law coefficients ``a, b, c, d`` for relative permittivity and
conductivity, a scattering coefficient ``s`` in [0, 1], scattering-lobe ratios
``s1, s2, s3`` and integer lobe widths ``s1_alpha, s3_alpha``.

Array-first redesign: instead of a global C struct array, materials live in a
:class:`MaterialTable` pytree of dense ``float32`` arrays indexed by material id.
Every column is a JAX leaf, so gradients w.r.t. permittivity/conductivity
coefficients and roughness flow through the tracer (the north-star requirement).
The frequency-dependent complex permittivity precompute
(``/root/reference/src/compute_paths.c:171-206``) lives in
:mod:`hermespy_rt_tpu.ops.fresnel` and consumes this table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "MaterialTable",
    "MATERIAL_NAMES",
    "MATERIAL_KEYS",
    "NUM_MATERIALS",
    "default_materials",
    "get_material_index",
]

# Material ids, mirroring the reference ``MaterialIndex`` enum
# (/root/reference/inc/materials.h:12-30).
MATERIAL_AIR = 0
MATERIAL_CONCRETE = 1
MATERIAL_BRICK = 2
MATERIAL_PLASTERBOARD = 3
MATERIAL_WOOD = 4
MATERIAL_GLASS1 = 5
MATERIAL_GLASS2 = 6
MATERIAL_CEILING_BOARD1 = 7
MATERIAL_CEILING_BOARD2 = 8
MATERIAL_CHIPBOARD = 9
MATERIAL_PLYWOOD = 10
MATERIAL_MARBLE = 11
MATERIAL_FLOORBOARD = 12
MATERIAL_METAL = 13
MATERIAL_VERY_DRY_GROUND = 14
MATERIAL_MEDIUM_DRY_GROUND = 15
MATERIAL_WET_GROUND = 16

NUM_MATERIALS = 17

# Display names (reference rows /root/reference/src/materials.c:3-89).
MATERIAL_NAMES: List[str] = [
    "air", "concrete", "brick", "plasterboard", "wood", "glass", "glass",
    "ceiling board", "ceiling board", "chipboard", "plywood", "marble",
    "floorboard", "metal", "very dry ground", "medium dry ground", "wet ground",
]

# Lookup keys (reference name->index map /root/reference/src/materials.c:98-115).
MATERIAL_KEYS: Dict[str, int] = {
    "air": MATERIAL_AIR,
    "concrete": MATERIAL_CONCRETE,
    "brick": MATERIAL_BRICK,
    "plasterboard": MATERIAL_PLASTERBOARD,
    "wood": MATERIAL_WOOD,
    "glass1": MATERIAL_GLASS1,
    "glass2": MATERIAL_GLASS2,
    "ceiling_board1": MATERIAL_CEILING_BOARD1,
    "ceiling_board2": MATERIAL_CEILING_BOARD2,
    "chipboard": MATERIAL_CHIPBOARD,
    "plywood": MATERIAL_PLYWOOD,
    "marble": MATERIAL_MARBLE,
    "floorboard": MATERIAL_FLOORBOARD,
    "metal": MATERIAL_METAL,
    "very_dry_ground": MATERIAL_VERY_DRY_GROUND,
    "medium_dry_ground": MATERIAL_MEDIUM_DRY_GROUND,
    "wet_ground": MATERIAL_WET_GROUND,
}

# ITU-R P.2040-3 Table 3 coefficient rows: (a, b, c, d, s, s1, s2, s3,
# s1_alpha, s3_alpha) per material id; public physical constants, identical to
# the reference database (/root/reference/src/materials.c:3-89) so that path
# gains are bit-comparable.
_ITU_ROWS = [
    # a,      b,     c,         d,      s,    s1,   s2,   s3,  s1a, s3a
    (1.0,    0.0,   0.0,       0.001,  0.1,  0.5,  0.3,  0.2,  2,  2),   # air
    (5.24,   0.0,   0.0462,    0.7822, 0.5,  0.33, 0.34, 0.33, 4,  4),   # concrete
    (3.91,   0.0,   0.0238,    0.16,   0.4,  0.4,  0.3,  0.3,  3,  3),   # brick
    (2.73,   0.0,   0.0085,    0.9395, 0.3,  0.4,  0.4,  0.2,  3,  3),   # plasterboard
    (1.99,   0.0,   0.0047,    1.0718, 0.2,  0.5,  0.3,  0.2,  2,  2),   # wood
    (6.31,   0.0,   0.0036,    1.3394, 0.3,  0.4,  0.4,  0.2,  3,  3),   # glass (1)
    (5.79,   0.0,   0.0004,    1.658,  0.3,  0.4,  0.4,  0.2,  3,  3),   # glass (2)
    (1.48,   0.0,   0.0011,    1.0750, 0.2,  0.5,  0.3,  0.2,  2,  2),   # ceiling board (1)
    (1.52,   0.0,   0.0029,    1.029,  0.2,  0.5,  0.3,  0.2,  2,  2),   # ceiling board (2)
    (2.58,   0.0,   0.0217,    0.7800, 0.4,  0.4,  0.3,  0.3,  3,  3),   # chipboard
    (2.71,   0.0,   0.33,      0.0,    0.3,  0.5,  0.3,  0.2,  3,  3),   # plywood
    (7.074,  0.0,   0.0055,    0.9262, 0.3,  0.4,  0.4,  0.2,  3,  3),   # marble
    (3.66,   0.0,   0.0044,    1.3515, 0.3,  0.4,  0.4,  0.2,  3,  3),   # floorboard
    (1.0,    0.0,   1.0e7,     0.0,    0.0,  0.0,  1.0,  0.0,  1,  1),   # metal
    (3.0,    0.0,   0.00015,   2.52,   0.4,  0.3,  0.4,  0.3,  4,  4),   # very dry ground
    (15.0,  -0.1,   0.035,     1.63,   0.5,  0.33, 0.34, 0.33, 4,  4),   # medium dry ground
    (30.0,  -0.4,   0.15,      1.30,   0.5,  0.33, 0.34, 0.33, 4,  4),   # wet ground
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Dense, differentiable material parameter table.

    Each field is a ``float32[M]`` array indexed by material id.  ``a, b``
    parameterise relative permittivity ``eps' = a * f_GHz**b`` and ``c, d``
    conductivity ``sigma = c * f_GHz**d`` (ITU-R P.2040-3 eqs. 28-29);
    ``s`` is the scattering coefficient; ``s1/s2/s3`` the lobe ratios;
    ``s1_alpha/s3_alpha`` the lobe widths (stored as float so they are
    differentiable — the tracer uses them inside ``exp``).
    """

    a: jax.Array
    b: jax.Array
    c: jax.Array
    d: jax.Array
    s: jax.Array
    s1: jax.Array
    s2: jax.Array
    s3: jax.Array
    s1_alpha: jax.Array
    s3_alpha: jax.Array

    @property
    def num_materials(self) -> int:
        return self.a.shape[0]

    def replace(self, **kw) -> "MaterialTable":
        return dataclasses.replace(self, **kw)


def default_materials(dtype=jnp.float32) -> MaterialTable:
    """Build the 17-row ITU-R P.2040-3 table used by the reference tracer."""
    rows = np.asarray(_ITU_ROWS, dtype=np.float32)
    cols = [jnp.asarray(rows[:, i], dtype=dtype) for i in range(10)]
    return MaterialTable(*cols)


def get_material_index(name: str) -> int:
    """Material id for ``name``; unknown names map to air (id 0), matching the
    reference fallback (/root/reference/src/materials.c:117-122)."""
    return MATERIAL_KEYS.get(name, MATERIAL_AIR)
