"""The training step that bench.py times and chip_smoke.py checks.

``jax.jit(jax.value_and_grad(loss))`` over the material table through
``tracer.trace_paths``, where the loss is the scatter power; the generated
street (224 triangles) and city (131,072 triangles) of ``config5_scene``;
transmitter/receiver positions in a street of each; and the GPU check both
scripts start with.
"""
from __future__ import annotations

import os
import subprocess
import time

import numpy as np

FULL_RAYS = 1 << 20
BOUNCES = 3
ITERS = 8
# positions in a street of each generated scene (config5_scene.py layout)
TX = {"street": (-20.0, -10.0, 10.0), "city": (27.7, -10.0, 10.0)}
RX0 = {"street": (10.0, 5.0, 2.0), "city": (27.7, 45.0, 1.5)}
RX_STEP = (1.5, -2.0, 0.25)


def gpu_device():
    """(JAX's first device, nvidia-smi's "name, power limit" line); raises
    SystemExit unless that device is a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU (JAX's first device is {dev.platform!r}); "
                         f"refusing to run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return dev, smi


def make_scenes(work_dir, names=("street", "city")):
    """{name: (xml_path, TriangleSoA)} for the generated scenes."""
    from config5_scene import CITY, STREET, make_city
    from hermespy_rt_tpu.scene import flatten_scene, load_scene
    sizes = {"street": STREET, "city": CITY}
    out = {}
    for name in names:
        xml = make_city(os.path.join(work_dir, name), **sizes[name])
        out[name] = (xml, flatten_scene(load_scene(xml)))
    return out


def positions(scene: str, nrx: int):
    """(rx f32[nrx, 3], tx f32[1, 3]) in a street of ``scene``."""
    rx = (np.asarray(RX0[scene], np.float32)[None]
          + np.arange(nrx, dtype=np.float32)[:, None]
          * np.asarray(RX_STEP, np.float32)[None])
    return rx, np.asarray([TX[scene]], np.float32)


def step_config(scene, num_paths, num_bounces=BOUNCES, **kw):
    """The step's config: street runs reference parity, city physical;
    dead-ray skipping, coherent launch order, material-only gradients."""
    from hermespy_rt_tpu.config import TracerConfig
    return TracerConfig(
        num_paths=num_paths, num_bounces=num_bounces,
        parity="physical" if scene == "city" else "reference",
        keep_rays=False, unroll_bounces=True, compact_rays=True,
        launch_order="coherent", grad_geometry=False, **kw)


def scatter_power(result):
    """The loss: total scatter power, scaled into f32's comfortable range."""
    import jax.numpy as jnp
    return (jnp.sum(jnp.abs(result.scatter.a_te) ** 2)
            + jnp.sum(jnp.abs(result.scatter.a_tm) ** 2)) * 1e9


def make_step(tris, cfg, rx, tx, intersect_fn=None):
    """The user's training step: value_and_grad of the scatter power over
    the material table; the scatter gains ride along as aux."""
    import jax
    import jax.numpy as jnp
    from hermespy_rt_tpu.tracer import trace_paths
    zrx = jnp.zeros(rx.shape, jnp.float32)
    ztx = jnp.zeros(tx.shape, jnp.float32)

    def loss(mats):
        r = trace_paths(tris, mats, rx, tx, zrx, ztx, jnp.float32(3.0), cfg,
                        intersect_fn=intersect_fn)
        return scatter_power(r), (r.scatter.a_te, r.scatter.a_tm)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def queries_per_step(cfg, nrx, ntx=1):
    """Nearest-hit queries of one trace: B * ntx * P * (1 + nrx)."""
    return cfg.num_bounces * ntx * cfg.num_paths * (1 + nrx)


def time_call(fn, *args, iters=ITERS):
    """Mean seconds per call over ``iters`` calls after one warm-up, closed
    by ``block_until_ready``; also returns the last output."""
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out
