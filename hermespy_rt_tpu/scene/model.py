"""Scene data model: host-side meshes and the device-side triangle SoA pytree.

Capability parity with the reference scene model
(``/root/reference/inc/scene.h:10-32``): a scene is a list of triangle meshes,
each with vertices, triangle vertex indices, a material id and a rigid-body
velocity (used for Doppler).

Array-first redesign: the reference keeps an array-of-structs ``Mesh*`` and
walks mesh-by-mesh, triangle-by-triangle inside the intersection loop
(reference ``src/compute_paths.c:253-255``).  On the accelerator the
entire scene is flattened once into a structure-of-arrays :class:`TriangleSoA`
— per-triangle vertex/edge/normal/material/velocity arrays padded to a tile
multiple — so the
intersection kernel is a dense, statically-shaped reduction over the triangle
axis.  Padding triangles are degenerate (zero edges), which makes their
Möller–Trumbore determinant exactly 0 and therefore can never be hit.
"""
from __future__ import annotations

import dataclasses
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["HostMesh", "HostScene", "TriangleSoA", "flatten_scene"]


@dataclasses.dataclass
class HostMesh:
    """One triangle mesh on the host (numpy). Mirrors the reference ``Mesh``
    struct (/root/reference/inc/scene.h:10-27) minus the lazily-computed
    normals, which the device pipeline derives during flattening."""

    vertices: np.ndarray          # float32[V, 3]
    indices: np.ndarray           # uint32[F, 3]
    material_index: int = 0
    velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    name: str = ""

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32).reshape(-1, 3)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.uint32).reshape(-1, 3)
        self.velocity = np.asarray(self.velocity, dtype=np.float32).reshape(3)

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


@dataclasses.dataclass
class HostScene:
    """A collection of meshes (reference ``Scene``, /root/reference/inc/scene.h:29-32)."""

    meshes: List[HostMesh]

    @property
    def num_meshes(self) -> int:
        return len(self.meshes)

    @property
    def num_triangles(self) -> int:
        return sum(m.num_triangles for m in self.meshes)

    def bounding_box(self):
        lo = np.min([m.vertices.min(0) for m in self.meshes], axis=0)
        hi = np.max([m.vertices.max(0) for m in self.meshes], axis=0)
        return lo, hi


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TriangleSoA:
    """Flattened scene geometry on device.

    ``v0/e1/e2`` are the Möller–Trumbore triangle basis (first vertex and the
    two edges), ``normal`` the unit geometric normal
    ``normalize((v2-v1)x(v3-v1))`` exactly as precomputed by the reference
    (/root/reference/src/compute_paths.c:208-224).  ``material`` and
    ``velocity`` are broadcast per-triangle from their mesh.  Arrays are padded
    to ``pad_triangles`` rows; rows ``>= num_triangles`` are degenerate.
    ``num_triangles`` is static metadata (not a leaf) so jitted code can slice.
    """

    v0: jax.Array        # f32[T, 3]
    e1: jax.Array        # f32[T, 3]
    e2: jax.Array        # f32[T, 3]
    normal: jax.Array    # f32[T, 3]
    velocity: jax.Array  # f32[T, 3]
    material: jax.Array  # i32[T]
    mesh_id: jax.Array   # i32[T]
    num_triangles: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def pad_triangles(self) -> int:
        return self.v0.shape[0]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Spatial sort permutation: 3x10-bit Morton codes of triangle centroids.

    Groups nearby triangles into the same kernel tile so per-tile AABBs are
    tight (the BVH substitute for 100k+-triangle Sionna scenes — SURVEY.md §5
    triangle-scaling row)."""
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    q = np.clip(((centroids - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):  # interleave 10 bits with 2-bit gaps
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def flatten_scene(scene: HostScene, pad_to: int = 128,
                  sort_triangles: bool = False) -> TriangleSoA:
    """Flatten all meshes into a padded :class:`TriangleSoA`.

    The reference computes normals per mesh at trace time
    (/root/reference/src/compute_paths.c:208-224); here they are computed once
    at flatten time, in float32 and in the same operation order
    (``normalize(cross(v2 - v1, v3 - v1))``) for parity.

    ``sort_triangles`` reorders triangles along a Morton curve for tight
    kernel-tile AABBs (enables effective culling on large scenes).  Off by
    default: reordering changes which triangle index wins exact-tie nearest
    hits, so golden-parity runs keep file order (the reference's first-hit
    tie-break is file-order dependent).
    """
    v0s, e1s, e2s, mats, vels, mids = [], [], [], [], [], []
    for mi, mesh in enumerate(scene.meshes):
        if mesh.num_triangles == 0:
            continue
        tri = mesh.vertices[mesh.indices.astype(np.int64)]  # [F, 3, 3]
        v1, v2, v3 = tri[:, 0], tri[:, 1], tri[:, 2]
        v0s.append(v1)
        e1s.append(v2 - v1)
        e2s.append(v3 - v1)
        mats.append(np.full(mesh.num_triangles, mesh.material_index, np.int32))
        vels.append(np.broadcast_to(mesh.velocity, (mesh.num_triangles, 3)))
        mids.append(np.full(mesh.num_triangles, mi, np.int32))

    v0 = np.concatenate(v0s, axis=0).astype(np.float32)
    e1 = np.concatenate(e1s, axis=0).astype(np.float32)
    e2 = np.concatenate(e2s, axis=0).astype(np.float32)
    n_un = np.cross(e1, e2)
    norm = np.sqrt(np.sum(n_un * n_un, axis=-1, keepdims=True))
    normal = (n_un / norm).astype(np.float32)
    material = np.concatenate(mats, axis=0)
    velocity = np.concatenate(vels, axis=0).astype(np.float32)
    mesh_id = np.concatenate(mids, axis=0)

    if sort_triangles and v0.shape[0] > 1:
        perm = _morton_order(v0 + (e1 + e2) / 3.0)
        v0, e1, e2, normal = v0[perm], e1[perm], e2[perm], normal[perm]
        material, velocity, mesh_id = (material[perm], velocity[perm],
                                       mesh_id[perm])

    num_t = v0.shape[0]
    pad_t = _round_up(max(num_t, 1), pad_to)

    def pad(x, fill=0.0):
        out = np.full((pad_t,) + x.shape[1:], fill, dtype=x.dtype)
        out[:num_t] = x
        return jnp.asarray(out)

    return TriangleSoA(
        v0=pad(v0), e1=pad(e1), e2=pad(e2), normal=pad(normal),
        velocity=pad(velocity), material=pad(material),
        mesh_id=pad(mesh_id, fill=-1), num_triangles=num_t,
    )
