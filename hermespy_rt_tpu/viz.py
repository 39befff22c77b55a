"""Ray/scene visualisation.

Capability parity with the reference OpenGL/GLUT viewer
(``/root/reference/viz/vizrays.c``): renders the scene triangles colour-coded
by mesh and the bounce-``k`` ray segments colour-coded by bounce depth,
honouring the per-ray active mask.  Redesigned headless-first (matplotlib 3D,
PNG/SVG output) since accelerator hosts have no display; :class:`RayViewer` /
:func:`vizrays` provide the interactive mode with the reference's controls —
orbit camera (mouse drag = yaw/pitch, scroll = dolly), ``w``/``a``/``s``/``d``
pan, ``q``/``e`` roll, and ``x``/``z`` bounce stepping
(/root/reference/viz/vizrays.c:200-279).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .scene.model import HostScene
from .tracer import RaysInfo

__all__ = ["plot_scene", "plot_rays", "save_rays_figure", "RayViewer",
           "vizrays"]

_BOUNCE_COLORS = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
                  "#8c564b", "#e377c2"]


def _require_mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt  # noqa: F401
    return matplotlib


def plot_scene(scene: HostScene, ax=None, alpha: float = 0.35):
    """Triangles colour-coded per mesh (viz/vizrays.c:51-71)."""
    _require_mpl()
    import matplotlib.pyplot as plt
    from matplotlib import colormaps
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if ax is None:
        fig = plt.figure(figsize=(9, 8))
        ax = fig.add_subplot(111, projection="3d")
    cmap = colormaps["tab20"]
    for mi, mesh in enumerate(scene.meshes):
        tri = mesh.vertices[mesh.indices.astype(np.int64)]
        coll = Poly3DCollection(tri, alpha=alpha,
                                facecolor=cmap(mi % 20), edgecolor="k",
                                linewidths=0.2)
        ax.add_collection3d(coll)
    lo, hi = scene.bounding_box()
    c = (lo + hi) / 2
    r = float(np.max(hi - lo)) / 2 or 1.0
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    return ax


def plot_rays(rays: RaysInfo, ax, bounces: Optional[Sequence[int]] = None,
              tx: int = 0, max_rays: int = 256, seg_len: float = 2.0):
    """Ray segments per bounce slot, colour-coded by depth and masked by
    activity (viz/vizrays.c:73-131).  ``seg_len`` draws inactive-terminal
    direction stubs like the reference's fixed-length segment display."""
    o = np.asarray(rays.origins[tx])       # [B+1, P, 3]
    d = np.asarray(rays.directions[tx])
    act = np.asarray(rays.active[tx])      # [B+1, P]
    nslots, P = act.shape
    sel = np.linspace(0, P - 1, min(max_rays, P)).astype(int)
    bounces = range(nslots) if bounces is None else bounces
    for b in bounces:
        color = _BOUNCE_COLORS[b % len(_BOUNCE_COLORS)]
        for p in sel:
            if not act[b, p]:
                continue
            start = o[b, p]
            if b + 1 < nslots and act[min(b + 1, nslots - 1), p]:
                end = o[b + 1, p]
            else:
                end = start + seg_len * d[b, p]
            ax.plot([start[0], end[0]], [start[1], end[1]],
                    [start[2], end[2]], color=color, linewidth=0.5,
                    alpha=0.7)
    return ax


class RayViewer:
    """Interactive scene+rays viewer with the reference's key bindings
    (/root/reference/viz/vizrays.c:200-279):

    * mouse drag — orbit (yaw/pitch); scroll — dolly (matplotlib built-ins)
    * ``x`` / ``z`` — step the displayed bounce slot up / down (:223-228)
    * ``w``/``a``/``s``/``d`` — pan the view in the screen plane (:230-246)
    * ``q`` / ``e`` — roll the camera (:248-252)

    Headless-safe: all handlers are plain methods, so tests can drive them
    without a display; ``show()`` blocks like the reference's
    ``glutMainLoop``.
    """

    def __init__(self, scene: HostScene, rays: RaysInfo, tx: int = 0,
                 max_rays: int = 512):
        _require_mpl()
        self.scene = scene
        self.rays = rays
        self.tx = tx
        self.max_rays = max_rays
        self.bounce = 0
        self.num_slots = int(np.asarray(rays.active[tx]).shape[0])
        self.ax = plot_scene(scene)
        self.fig = self.ax.figure
        self._ray_artists = []
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self._draw_rays()

    # -- drawing ----------------------------------------------------------
    def _draw_rays(self):
        for art in self._ray_artists:
            art.remove()
        before = set(self.ax.lines)
        plot_rays(self.rays, self.ax, bounces=[self.bounce], tx=self.tx,
                  max_rays=self.max_rays)
        self._ray_artists = [l for l in self.ax.lines if l not in before]
        self.ax.set_title(f"bounce {self.bounce}/{self.num_slots - 1} "
                          f"(x/z step, wasd pan, q/e roll)")
        self.fig.canvas.draw_idle()

    # -- controls ---------------------------------------------------------
    def step_bounce(self, delta: int):
        self.bounce = int(np.clip(self.bounce + delta, 0,
                                  self.num_slots - 1))
        self._draw_rays()

    def pan(self, dx: float, dy: float):
        """Pan in the screen plane by fractions of the current span."""
        for get_lim, set_lim, frac in (
                (self.ax.get_xlim, self.ax.set_xlim, dx),
                (self.ax.get_ylim, self.ax.set_ylim, dy)):
            lo, hi = get_lim()
            shift = (hi - lo) * frac
            set_lim(lo + shift, hi + shift)
        self.fig.canvas.draw_idle()

    def roll(self, degrees: float):
        elev = getattr(self.ax, "elev", 30.0)
        azim = getattr(self.ax, "azim", -60.0)
        roll = getattr(self.ax, "roll", 0.0) + degrees
        self.ax.view_init(elev=elev, azim=azim, roll=roll)
        self.fig.canvas.draw_idle()

    def on_key(self, event):
        key = (event.key or "").lower()
        if key == "x":
            self.step_bounce(+1)
        elif key == "z":
            self.step_bounce(-1)
        elif key == "w":
            self.pan(0.0, +0.1)
        elif key == "s":
            self.pan(0.0, -0.1)
        elif key == "a":
            self.pan(-0.1, 0.0)
        elif key == "d":
            self.pan(+0.1, 0.0)
        elif key == "q":
            self.roll(-10.0)
        elif key == "e":
            self.roll(+10.0)

    def show(self):
        """Blocking interactive loop (the reference's ``glutMainLoop``,
        /root/reference/viz/vizrays.c:311)."""
        import matplotlib.pyplot as plt
        plt.show()


def vizrays(scene: HostScene, rays: RaysInfo, tx: int = 0,
            show: bool = True, max_rays: int = 512) -> RayViewer:
    """Open the interactive ray viewer (reference ``vizrays``,
    /root/reference/viz/viz.h:22-26).  Returns the viewer; blocks in a UI
    loop when ``show`` (requires a display — on headless hosts use
    :func:`save_rays_figure` or ``show=False``)."""
    viewer = RayViewer(scene, rays, tx=tx, max_rays=max_rays)
    if show:
        viewer.show()
    return viewer


def save_rays_figure(scene: HostScene, rays: RaysInfo, path: str,
                     bounces: Optional[Sequence[int]] = None,
                     max_rays: int = 256, dpi: int = 130):
    """Render scene + rays to an image file; the headless equivalent of the
    reference's interactive ``vizrays`` window."""
    _require_mpl()
    import matplotlib.pyplot as plt

    ax = plot_scene(scene)
    plot_rays(rays, ax, bounces=bounces, max_rays=max_rays)
    ax.figure.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(ax.figure)
    return path
