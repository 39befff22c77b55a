"""Golden-test oracle: the reference C tracer compiled to a shared library.

Builds the reference checkout's ``src/{compute_paths,scene,materials}.c``
(GL-free core) into ``liboracle.so`` on first use and exposes
``compute_paths`` through ctypes.  This *runs* the reference for comparison — no reference code is
copied into the framework.  Note the ``size_t`` argtypes: the C signature
(reference ``inc/compute_paths.h:59-74``) takes ``size_t`` counts, so
ctypes must use ``c_size_t`` (SURVEY.md §7 M0 caveat).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from tests.utils import REF_DIR as REFERENCE_DIR, ref_path
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "liboracle.so")

_lib: Optional[ctypes.CDLL] = None


class Vec3(ctypes.Structure):
    _fields_ = [("x", ctypes.c_float), ("y", ctypes.c_float), ("z", ctypes.c_float)]


class Ray(ctypes.Structure):
    _fields_ = [("o", Vec3), ("d", Vec3)]


class Mesh(ctypes.Structure):
    _fields_ = [
        ("num_vertices", ctypes.c_uint32), ("vs", ctypes.POINTER(Vec3)),
        ("num_triangles", ctypes.c_uint32), ("is_", ctypes.POINTER(ctypes.c_uint32)),
        ("material_index", ctypes.c_uint32), ("velocity", Vec3),
        ("ns", ctypes.POINTER(Vec3)),
    ]


class Scene(ctypes.Structure):
    _fields_ = [("num_meshes", ctypes.c_uint32), ("meshes", ctypes.POINTER(Mesh))]


class CChannelInfo(ctypes.Structure):
    _fields_ = [
        ("num_rays", ctypes.c_uint32),
        ("directions_rx", ctypes.POINTER(Vec3)),
        ("directions_tx", ctypes.POINTER(Vec3)),
        ("a_te_re", ctypes.POINTER(ctypes.c_float)),
        ("a_te_im", ctypes.POINTER(ctypes.c_float)),
        ("a_tm_re", ctypes.POINTER(ctypes.c_float)),
        ("a_tm_im", ctypes.POINTER(ctypes.c_float)),
        ("tau", ctypes.POINTER(ctypes.c_float)),
        ("freq_shift", ctypes.POINTER(ctypes.c_float)),
    ]


class CRaysInfo(ctypes.Structure):
    _fields_ = [
        ("num_bounces", ctypes.c_uint32), ("num_rays", ctypes.c_uint32),
        ("rays", ctypes.POINTER(Ray)), ("rays_active", ctypes.POINTER(ctypes.c_uint8)),
    ]


def _build() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    srcs = [os.path.join(REFERENCE_DIR, "src", f)
            for f in ("compute_paths.c", "scene.c", "materials.c")]
    # -fno-builtin and -Wl,-Bsymbolic are load-bearing: the reference defines
    # its own ``void csqrtf(...)`` (reference ``src/compute_paths.c:136``)
    # that collides with the libm symbol.  Without them, (a) gcc -O2 treats
    # calls to it as the pure builtin and may delete them, and (b) in a shared
    # library the PLT resolves csqrtf to libm's (already loaded by Python),
    # so the precomputed complex-sqrt table stays zero.  The reference's own
    # statically-linked test.elf binds to its local definition, which is the
    # behavior the oracle must reproduce.
    cmd = ["gcc", "-O2", "-fno-builtin", "-shared", "-fPIC", "-Wl,-Bsymbolic",
           "-o", _LIB_PATH, *srcs, "-lm"]
    subprocess.run(cmd, check=True, capture_output=True)


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        ref_path("src")          # skips the calling test without a checkout
        if not os.path.exists(_LIB_PATH) or (
            os.path.getmtime(_LIB_PATH)
            < max(os.path.getmtime(os.path.join(REFERENCE_DIR, "src", f))
                  for f in ("compute_paths.c", "scene.c", "materials.c"))):
            _build()
        _lib = ctypes.CDLL(_LIB_PATH)
        _lib.scene_load.restype = Scene
        _lib.scene_load.argtypes = [ctypes.c_char_p]
        _lib.compute_paths.restype = None
        _lib.compute_paths.argtypes = [
            ctypes.POINTER(Scene),
            ctypes.POINTER(Vec3), ctypes.POINTER(Vec3),
            ctypes.POINTER(Vec3), ctypes.POINTER(Vec3),
            ctypes.c_float,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.POINTER(CChannelInfo), ctypes.POINTER(CRaysInfo),
            ctypes.POINTER(CChannelInfo), ctypes.POINTER(CRaysInfo),
        ]
    return _lib


@dataclass
class OracleChannel:
    directions_rx: np.ndarray  # (nrx, ntx, K, 3)
    directions_tx: np.ndarray
    a_te: np.ndarray           # complex64 (nrx, ntx, K)
    a_tm: np.ndarray
    tau: np.ndarray
    freq_shift: np.ndarray


@dataclass
class OracleResult:
    los: OracleChannel
    scatter: OracleChannel
    los_active: np.ndarray       # bool (nrx*ntx,)
    scat_rays: np.ndarray        # f32 (ntx*(B+1)*P, 6) raw ray dump
    scat_active_bits: np.ndarray  # raw bitmask bytes


def _alloc_chan(nrx, ntx, k) -> Tuple[CChannelInfo, dict]:
    n = nrx * ntx * k
    bufs = {
        "directions_rx": np.zeros((n, 3), np.float32),
        "directions_tx": np.zeros((n, 3), np.float32),
        "a_te_re": np.zeros(n, np.float32), "a_te_im": np.zeros(n, np.float32),
        "a_tm_re": np.zeros(n, np.float32), "a_tm_im": np.zeros(n, np.float32),
        "tau": np.zeros(n, np.float32), "freq_shift": np.zeros(n, np.float32),
    }
    ci = CChannelInfo(
        num_rays=k,
        directions_rx=bufs["directions_rx"].ctypes.data_as(ctypes.POINTER(Vec3)),
        directions_tx=bufs["directions_tx"].ctypes.data_as(ctypes.POINTER(Vec3)),
        a_te_re=bufs["a_te_re"].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        a_te_im=bufs["a_te_im"].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        a_tm_re=bufs["a_tm_re"].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        a_tm_im=bufs["a_tm_im"].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tau=bufs["tau"].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        freq_shift=bufs["freq_shift"].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return ci, bufs


def run_reference(hrt_path: str, rx_pos, tx_pos, rx_vel, tx_vel,
                  carrier_frequency_ghz: float, num_paths: int,
                  num_bounces: int) -> OracleResult:
    """Run the compiled C reference tracer; returns numpy views shaped like
    the pybind wrapper's outputs (/root/reference/compute_paths_pybind11.cpp:122-152)."""
    lib = _get_lib()
    rx_pos = np.ascontiguousarray(rx_pos, np.float32).reshape(-1, 3)
    tx_pos = np.ascontiguousarray(tx_pos, np.float32).reshape(-1, 3)
    rx_vel = np.ascontiguousarray(rx_vel, np.float32).reshape(-1, 3)
    tx_vel = np.ascontiguousarray(tx_vel, np.float32).reshape(-1, 3)
    nrx, ntx = rx_pos.shape[0], tx_pos.shape[0]
    P, B = num_paths, num_bounces

    scene = lib.scene_load(hrt_path.encode())

    los_ci, los_bufs = _alloc_chan(nrx, ntx, 1)
    scat_ci, scat_bufs = _alloc_chan(nrx, ntx, B * P)

    los_rays = np.zeros((nrx * ntx, 6), np.float32)
    los_active = np.zeros(nrx * ntx // 8 + 1, np.uint8)
    los_ri = CRaysInfo(num_bounces=1, num_rays=1,
                       rays=los_rays.ctypes.data_as(ctypes.POINTER(Ray)),
                       rays_active=los_active.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    scat_rays = np.zeros((nrx * ntx * (B + 1) * P, 6), np.float32)
    scat_active = np.zeros(nrx * ntx * (B + 1) * P // 8 + 1, np.uint8)
    scat_ri = CRaysInfo(num_bounces=B + 1, num_rays=B * P,
                        rays=scat_rays.ctypes.data_as(ctypes.POINTER(Ray)),
                        rays_active=scat_active.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))

    lib.compute_paths(
        ctypes.byref(scene),
        rx_pos.ctypes.data_as(ctypes.POINTER(Vec3)),
        tx_pos.ctypes.data_as(ctypes.POINTER(Vec3)),
        rx_vel.ctypes.data_as(ctypes.POINTER(Vec3)),
        tx_vel.ctypes.data_as(ctypes.POINTER(Vec3)),
        ctypes.c_float(carrier_frequency_ghz),
        nrx, ntx, P, B,
        ctypes.byref(los_ci), ctypes.byref(los_ri),
        ctypes.byref(scat_ci), ctypes.byref(scat_ri),
    )

    def chan(bufs, k):
        shp = (nrx, ntx, k)
        return OracleChannel(
            directions_rx=bufs["directions_rx"].reshape(shp + (3,)),
            directions_tx=bufs["directions_tx"].reshape(shp + (3,)),
            a_te=(bufs["a_te_re"] + 1j * bufs["a_te_im"]).astype(np.complex64).reshape(shp),
            a_tm=(bufs["a_tm_re"] + 1j * bufs["a_tm_im"]).astype(np.complex64).reshape(shp),
            tau=bufs["tau"].reshape(shp),
            freq_shift=bufs["freq_shift"].reshape(shp),
        )

    los_active_bool = np.unpackbits(los_active, bitorder="little")[:nrx * ntx].astype(bool)
    return OracleResult(
        los=chan(los_bufs, 1), scatter=chan(scat_bufs, B * P),
        los_active=los_active_bool, scat_rays=scat_rays,
        scat_active_bits=scat_active,
    )
