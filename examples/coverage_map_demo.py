#!/usr/bin/env python
"""End-to-end demo: coverage map of a TX in a street scene.

Usage:  python examples/coverage_map_demo.py [scene] [out.png]

Without a scene argument it traces the generated street
(benchmarks/config5_scene.py STREET, 224 triangles).

Traces a probe grid over the scene footprint, renders path-gain /
delay-spread / LoS-blockage maps, and prints summary statistics.
"""
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import hermespy_rt_tpu as hrt
from hermespy_rt_tpu.models.coverage import coverage_map


def main():
    out_png = sys.argv[2] if len(sys.argv) > 2 else "coverage.png"
    if len(sys.argv) > 1:
        scene = hrt.load_scene(sys.argv[1])
    else:
        from config5_scene import STREET, make_city
        with tempfile.TemporaryDirectory() as work:
            scene = hrt.load_scene(make_city(work, **STREET))
    lo, hi = scene.bounding_box()
    print(f"scene: {scene.num_meshes} meshes, {scene.num_triangles} tris, "
          f"bbox {np.round(lo, 1)}..{np.round(hi, 1)}")

    tx = [[(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, hi[2] * 0.8]]
    grid = coverage_map(
        scene, tx,
        x_range=(float(lo[0]), float(hi[0])),
        y_range=(float(lo[1]), float(hi[1])),
        resolution=max(float(hi[0] - lo[0]), float(hi[1] - lo[1])) / 40,
        height=1.5, carrier_frequency_ghz=3.0,
        config=hrt.TracerConfig(num_paths=2048, num_bounces=3,
                                keep_rays=False))

    print(f"gain: median {np.median(grid.gain_db):.1f} dB, "
          f"p10 {np.percentile(grid.gain_db, 10):.1f} dB")
    print(f"LoS blocked: {grid.los_blocked.mean():.1%} of cells")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))
    for ax, data, title, cmap in (
            (axes[0], grid.gain_db, "path gain [dB]", "viridis"),
            (axes[1], grid.rms_delay * 1e9, "RMS delay spread [ns]", "magma"),
            (axes[2], grid.los_blocked.astype(float), "LoS blocked", "gray")):
        im = ax.imshow(data, origin="lower",
                       extent=(grid.x[0], grid.x[-1], grid.y[0], grid.y[-1]))
        im.set_cmap(cmap)
        ax.plot(tx[0][0], tx[0][1], "r*", markersize=14)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.85)
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    print(f"wrote {out_png}")


if __name__ == "__main__":
    main()
