"""Public user-facing API.

Drop-in parity with the reference Python module surface
(``/root/reference/compute_paths_pybind11.cpp:99-210`` and
``/root/reference/__init__.py``): :func:`compute_paths` takes the same ten
arguments (scene path, rx/tx positions & velocities, carrier frequency in GHz,
counts) and returns ``(los, scatter)`` ChannelInfo objects with numpy-matching
shapes — directions ``(num_rx, num_tx, num_rays, 3)``, complex64 gains and f32
``tau``/``freq_shift`` ``(num_rx, num_tx, num_rays)``.

The extended entry point :func:`trace` exposes the full surface:
scene objects, differentiable material tables, tracer configs, sharding and
ray-segment outputs.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .config import TracerConfig
from .materials import MaterialTable, default_materials
from .ops.geometry import fibonacci_sphere
from .scene.model import HostScene, TriangleSoA, flatten_scene
from .scene.sionna import load_scene
from .tracer import ChannelInfo, PathsResult, trace_paths

__all__ = ["compute_paths", "trace", "prepare_scene"]

SceneLike = Union[str, HostScene, TriangleSoA]


def prepare_scene(scene: SceneLike, pad_to: int = 128,
                  sort_triangles: bool = False) -> TriangleSoA:
    """Resolve a path / host scene / prepared SoA to a device TriangleSoA.

    ``sort_triangles=True`` Morton-orders triangles for tight kernel-tile
    AABBs — combined with ``TracerConfig(cull=True)`` this gave 3x on a
    131k-triangle scene (see benchmarks/README.md).  Keep it off for golden
    parity runs (exact-tie nearest hits follow file order in the reference).
    """
    if isinstance(scene, TriangleSoA):
        return scene
    if isinstance(scene, HostScene):
        return flatten_scene(scene, pad_to=pad_to,
                             sort_triangles=sort_triangles)
    return flatten_scene(load_scene(scene), pad_to=pad_to,
                         sort_triangles=sort_triangles)


@partial(jax.jit, static_argnames=("cfg",))
def _traced(tris, materials, rx_pos, tx_pos, rx_vel, tx_vel, f_ghz,
            launch_dirs, cfg: TracerConfig) -> PathsResult:
    return trace_paths(tris, materials, rx_pos, tx_pos, rx_vel, tx_vel,
                       f_ghz, cfg, launch_dirs=launch_dirs)


@lru_cache(maxsize=64)
def _cached_dirs(num_paths: int, order: str = "fibonacci"):
    dirs = fibonacci_sphere(num_paths)
    if order == "coherent":
        from .scene.model import _morton_order
        dirs = dirs[_morton_order(np.asarray(dirs))]
    return jnp.asarray(dirs)


def trace(scene: SceneLike,
          rx_positions, tx_positions,
          rx_velocities=None, tx_velocities=None,
          carrier_frequency: float = 3.0,
          config: Optional[TracerConfig] = None,
          materials: Optional[MaterialTable] = None) -> PathsResult:
    """Full-featured tracing entry point (jitted; differentiable via
    :func:`hermespy_rt_tpu.tracer.trace_paths` if you need custom transforms).
    """
    cfg = config or TracerConfig()
    # measured policy: Morton-sort triangles for non-parity configs at scale
    # (tight kernel-tile AABBs feed the walk/culled kernels; parity runs
    # keep file order — the reference's exact-tie nearest hit follows it)
    if not isinstance(scene, TriangleSoA):
        host = scene if isinstance(scene, HostScene) else load_scene(scene)
        n_tris = sum(m.indices.shape[0] for m in host.meshes)
        scene = flatten_scene(
            host, sort_triangles=(cfg.parity != "reference"
                                  and n_tris >= 4096))
    tris = scene
    mats = materials if materials is not None else default_materials()
    rx_pos = jnp.asarray(rx_positions, jnp.float32).reshape(-1, 3)
    tx_pos = jnp.asarray(tx_positions, jnp.float32).reshape(-1, 3)
    rx_vel = (jnp.zeros_like(rx_pos) if rx_velocities is None
              else jnp.asarray(rx_velocities, jnp.float32).reshape(-1, 3))
    tx_vel = (jnp.zeros_like(tx_pos) if tx_velocities is None
              else jnp.asarray(tx_velocities, jnp.float32).reshape(-1, 3))
    return _traced(tris, mats, rx_pos, tx_pos, rx_vel, tx_vel,
                   jnp.float32(carrier_frequency),
                   _cached_dirs(cfg.num_paths, cfg.resolved_launch_order),
                   cfg)


def compute_paths(mesh_filepath: SceneLike,
                  rx_positions, tx_positions,
                  rx_velocities, tx_velocities,
                  carrier_frequency: float,
                  num_rx: int, num_tx: int,
                  num_paths: int, num_bounces: int,
                  **kwargs) -> Tuple[ChannelInfo, ChannelInfo]:
    """Reference-compatible entry point (matches
    /root/reference/compute_paths_pybind11.cpp:188-210 argument-for-argument).

    Returns ``(los, scatter)`` with the reference's output shapes.  Extra
    keyword arguments are forwarded to :class:`TracerConfig` (e.g.
    ``parity="physical"``, ``backend="pallas"``).
    """
    rx_positions = np.asarray(rx_positions, np.float32).reshape(-1, 3)
    tx_positions = np.asarray(tx_positions, np.float32).reshape(-1, 3)
    if rx_positions.shape[0] != num_rx:
        raise ValueError(f"rx_positions has {rx_positions.shape[0]} rows, expected {num_rx}")
    if tx_positions.shape[0] != num_tx:
        raise ValueError(f"tx_positions has {tx_positions.shape[0]} rows, expected {num_tx}")
    cfg = TracerConfig(num_paths=num_paths, num_bounces=num_bounces, **kwargs)
    result = trace(mesh_filepath, rx_positions, tx_positions,
                   rx_velocities, tx_velocities, carrier_frequency, config=cfg)
    return result.los, result.scatter
