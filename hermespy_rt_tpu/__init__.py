"""hermespy_rt_tpu — a differentiable RF ray tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
``hermespy-rt`` C reference (multipath channel parameters — complex TE/TM path
gains, delays, Doppler shifts, departure/arrival directions — between TX and RX
sets in triangle-mesh scenes), built as array programs for an accelerator
(an NVIDIA GPU; the CPU for tests): dense SoA scenes, scanned bounce loops, a
Pallas (Triton) intersection kernel, shard_map multi-device scaling and
end-to-end differentiability w.r.t. materials, positions and geometry.
"""
from .api import compute_paths, trace, prepare_scene
from .config import TracerConfig
from .materials import MaterialTable, default_materials, get_material_index
from .scene import (HostMesh, HostScene, TriangleSoA, flatten_scene, load_hrt,
                    save_hrt, load_scene, load_sionna_xml, load_ply,
                    box_scene, simple_reflector_scene)
from .tracer import ChannelInfo, PathsResult, RaysInfo, trace_paths
from . import models, parallel, utils  # noqa: F401 (subsystem namespaces)

__version__ = "0.1.0"

__all__ = [
    "compute_paths", "trace", "prepare_scene", "TracerConfig",
    "MaterialTable", "default_materials", "get_material_index",
    "HostMesh", "HostScene", "TriangleSoA", "flatten_scene",
    "load_hrt", "save_hrt", "load_scene", "load_sionna_xml", "load_ply",
    "box_scene", "simple_reflector_scene",
    "ChannelInfo", "PathsResult", "RaysInfo", "trace_paths",
    "__version__",
]
