#!/usr/bin/env python
"""Synthesize a BASELINE config-5 scale Sionna scene (131,072 triangles).

Writes a Mitsuba/Sionna-style ``city.xml`` + binary PLY meshes — a
procedural city: a subdivided ground plane plus a grid of box buildings with
subdivided faces — exercising the real importer path end to end
(XML + PLY + to_world transform + ITU material refs; the reference's
converter handles exactly these inputs,
/root/reference/src/scene_fromSionna.c:255-454).  Sizes default to
160 buildings x 768 tris + 64x64x2 ground = 131,072 triangles exactly.
"""
import os
import struct

import numpy as np

__all__ = ["make_city", "write_ply", "STREET", "CITY"]

# The two generated scenes the benchmark and the chip smoke trace:
# "street" — 4 buildings + ground, 224 triangles, canyon-class;
# "city"   — the defaults, 131,072 triangles (BASELINE config 5).
STREET = dict(n_buildings=4, sub=2, ground_sub=4)
CITY = dict()


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY (x,y,z float32 verts, uchar-counted
    triangle faces) — the layout the reference reader expects
    (/root/reference/src/scene_fromSionna.c:103-164, minus the s,t columns
    it skips)."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.uint32)
    with open(path, "wb") as fh:
        fh.write(b"ply\nformat binary_little_endian 1.0\n")
        fh.write(f"element vertex {len(v)}\n".encode())
        fh.write(b"property float x\nproperty float y\nproperty float z\n")
        fh.write(f"element face {len(f)}\n".encode())
        fh.write(b"property list uchar int vertex_indices\nend_header\n")
        fh.write(v.astype("<f4").tobytes())
        rec = np.empty((len(f), 13), np.uint8)
        rec[:, 0] = 3
        rec[:, 1:] = f.astype("<u4").view(np.uint8).reshape(len(f), 12)
        fh.write(rec.tobytes())


def _grid_quads(nx: int, ny: int):
    """Subdivided unit-square triangulation: verts [(nx+1)*(ny+1), 2] in
    [0,1]^2 and faces [nx*ny*2, 3]."""
    xs = np.linspace(0.0, 1.0, nx + 1)
    ys = np.linspace(0.0, 1.0, ny + 1)
    vv = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = (i * (ny + 1) + j).ravel()
    v01 = v00 + 1
    v10 = v00 + (ny + 1)
    v11 = v10 + 1
    f = np.concatenate([np.stack([v00, v10, v11], -1),
                        np.stack([v00, v11, v01], -1)])
    return vv, f.astype(np.uint32)


def _box(cx, cy, w, d, h, sub):
    """Box with each face subdivided sub x sub; returns (verts, faces)."""
    verts, faces = [], []
    off = 0
    vv, ff = _grid_quads(sub, sub)

    def face(origin, eu, ev):
        nonlocal off
        p = (np.asarray(origin)[None, :]
             + vv[:, :1] * np.asarray(eu)[None, :]
             + vv[:, 1:2] * np.asarray(ev)[None, :])
        verts.append(p)
        faces.append(ff + off)
        off += len(vv)

    x0, x1 = cx - w / 2, cx + w / 2
    y0, y1 = cy - d / 2, cy + d / 2
    face([x0, y0, 0], [w, 0, 0], [0, d, 0])      # bottom
    face([x0, y0, h], [w, 0, 0], [0, d, 0])      # top
    face([x0, y0, 0], [w, 0, 0], [0, 0, h])      # -y
    face([x0, y1, 0], [w, 0, 0], [0, 0, h])      # +y
    face([x0, y0, 0], [0, d, 0], [0, 0, h])      # -x
    face([x1, y0, 0], [0, d, 0], [0, 0, h])      # +x
    return np.concatenate(verts), np.concatenate(faces)


_XML = """<scene version="2.1.0">
  <bsdf type="twosided" id="mat-itu_medium_dry_ground"/>
  <bsdf type="twosided" id="mat-itu_concrete"/>
  <shape type="ply" id="mesh-ground" name="ground">
    <string name="filename" value="meshes/ground.ply"/>
    <ref id="mat-itu_medium_dry_ground" name="bsdf"/>
  </shape>
  <shape type="ply" id="mesh-buildings" name="buildings">
    <string name="filename" value="meshes/buildings.ply"/>
    <ref id="mat-itu_concrete" name="bsdf"/>
    <transform name="to_world">
      <translate x="0" y="0" z="{zlift}"/>
    </transform>
  </shape>
</scene>
"""


def make_city(out_dir: str, n_buildings: int = 160, sub: int = 8,
              ground_sub: int = 64, extent: float = 400.0, seed: int = 0,
              zlift: float = 0.05) -> str:
    """Write the city scene; returns the path to ``city.xml``.

    Triangle count = n_buildings * 12 * sub^2 + 2 * ground_sub^2.
    The building mesh carries a to_world translate (baked by the importer)
    so the import path is exercised beyond a plain PLY read.
    """
    os.makedirs(os.path.join(out_dir, "meshes"), exist_ok=True)
    rng = np.random.default_rng(seed)

    gv, gf = _grid_quads(ground_sub, ground_sub)
    gverts = np.concatenate(
        [(gv - 0.5) * 2 * extent, np.zeros((len(gv), 1))], axis=1)
    write_ply(os.path.join(out_dir, "meshes", "ground.ply"), gverts, gf)

    side = int(np.ceil(np.sqrt(n_buildings)))
    pitch = 2 * extent * 0.9 / side
    verts, faces = [], []
    off = 0
    for b in range(n_buildings):
        gx, gy = b % side, b // side
        cx = -extent * 0.9 + (gx + 0.5) * pitch + rng.uniform(-2, 2)
        cy = -extent * 0.9 + (gy + 0.5) * pitch + rng.uniform(-2, 2)
        w = rng.uniform(0.35, 0.6) * pitch
        d = rng.uniform(0.35, 0.6) * pitch
        h = rng.uniform(8.0, 60.0)
        v, f = _box(cx, cy, w, d, h, sub)
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    write_ply(os.path.join(out_dir, "meshes", "buildings.ply"),
              np.concatenate(verts), np.concatenate(faces))

    xml_path = os.path.join(out_dir, "city.xml")
    with open(xml_path, "w") as fh:
        fh.write(_XML.format(zlift=zlift))
    return xml_path


if __name__ == "__main__":
    import sys
    if len(sys.argv) != 2:
        sys.exit("usage: config5_scene.py OUT_DIR")
    print(make_city(sys.argv[1]))
