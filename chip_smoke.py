#!/usr/bin/env python
"""Chip smoke: the fwd+bwd trace step of hermespy_rt_tpu on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a GPU):

    python chip_smoke.py            # phases a-d on one card
    python chip_smoke.py --multi    # phase e only, on four cards

Phases (each prints its findings; any failure exits non-zero):

  a. device       — refuse to run unless JAX's first device is a GPU; print
                    its kind, the JAX version and ``nvidia-smi``'s name and
                    power limit.
  b. intersection — the Pallas (Triton) kernel, compiled for the card, at
                    2^20 rays on the street and the city, against
                    ``intersect_jnp``: nearest, exclude, t_max, live and
                    any-hit queries.  Every hit-index flip must be a proven
                    f32 edge/tie case; times of the kernel and of
                    ``intersect_jnp`` (ray_chunk sweep), alone and in the step.
  c. main path    — ``jax.jit(jax.value_and_grad(loss))`` over the material
                    table through ``tracer.trace_paths``: street at nrx = 1,
                    4, 16 (parity "reference") and city at nrx = 1 (parity
                    "physical"), 2^20 paths, 3 bounces; take vs onehot
                    gather; the public ``hrt.trace`` / ``hrt.compute_paths``
                    on the city's XML at 65,536 rays.
  d. reference    — the street nrx=4 step at 65,536 rays on the GPU against
                    the same step on the CPU with ``backend="jnp"``.
  e. --multi      — ``parallel.trace_paths_sharded`` on the city over a
                    rays-only 4x1 mesh and a rays x tris 2x2 mesh, against
                    the same step on one card.

The step, the scenes (the seeded generator ``benchmarks/config5_scene.py``:
street, 224 triangles, canyon-class; city, 131,072 triangles) and the
positions come from ``benchmarks/train_step.py``, which bench.py times.  The
last line of stdout is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

from train_step import (BOUNCES, FULL_RAYS, ITERS, gpu_device,  # noqa: E402
                        make_scenes, make_step, positions,
                        queries_per_step, scatter_power, step_config,
                        time_call)

warnings.filterwarnings("ignore", message="launch_order='coherent' relabels")

REF_RAYS = 1 << 16
# jnp ray_chunk values whose [chunk, T, 3] f32 intermediates stay under this
# many bytes are swept (the city's 131k triangles rule out 65536 and 2^20)
JNP_CHUNK_BYTES = 8 << 30
JNP_CHUNKS = (4096, 65536, 1 << 20)


def log(*parts):
    print(*parts, flush=True)


def test_helpers():
    """tests/utils.py, loaded by path: a site package named ``tests`` may
    shadow the repository's test directory."""
    import importlib.util
    mod = sys.modules.get("hrt_test_utils")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "hrt_test_utils", os.path.join(REPO, "tests", "utils.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["hrt_test_utils"] = mod
    return mod


# ---------------------------------------------------------------- phase a

def phase_device():
    """The card JAX sees, or SystemExit."""
    import jax
    dev, smi = gpu_device()
    log(f"[a] platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} jax={jax.__version__}")
    log(smi)
    return dev, smi


# ----------------------------------------------------------------- phase b

def random_rays(tris, n: int, seed: int):
    """Rays from uniform points of the scene's bounding box in uniform
    directions (host numpy, seeded)."""
    rng = np.random.default_rng(seed)
    v = np.asarray(tris.v0)[:tris.num_triangles]
    lo, hi = v.min(0), v.max(0)
    hi = np.maximum(hi, lo + 1.0)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


# Where both sides agree on the hit index, t agrees to this relative
# tolerance plus T_ATOL_ULPS float32 ulps of the scene's largest coordinate:
# t is a difference of coordinates divided by det, so a hit a hair in front
# of its origin can never be known better than the coordinates' own rounding.
T_RTOL = 2e-5
T_ATOL_ULPS = 8


def compare_queries(tris, o, d, t1, i1, t2, i2, mask=None, t_max=None,
                    label=""):
    """Kernel (t2, i2) vs jnp (t1, i1): every hit-index flip must be an f32
    edge/tie case (tests/utils.py::assert_flips_explained), and t must match
    where the indices agree.  With ``t_max``, a hit<->miss flip whose hit
    lies within T_RTOL of the range limit is a range-boundary case (the two
    sides round t differently at the limit) and is counted apart.  Returns
    (flips, boundary flips)."""
    assert_flips_explained = test_helpers().assert_flips_explained
    o, d, t1, i1, t2, i2 = map(np.asarray, (o, d, t1, i1, t2, i2))
    if mask is not None:
        o, d, t1, i1, t2, i2 = (x[mask] for x in (o, d, t1, i1, t2, i2))
    keep = np.ones(i1.shape, bool)
    if t_max is not None:
        tm = np.broadcast_to(np.asarray(t_max), np.asarray(mask).shape
                             if mask is not None else i1.shape)
        tm = tm[mask] if mask is not None else tm
        t_hit = np.where(i1 >= 0, t1, t2)
        keep = ~(((i1 >= 0) != (i2 >= 0))
                 & (np.abs(t_hit - tm) <= T_RTOL * np.abs(tm)))
    flips = assert_flips_explained(tris, o[keep], d[keep], t1[keep],
                                   i1[keep], t2[keep], i2[keep], label=label)
    same = (i1 == i2) & (i1 >= 0)
    scale = float(np.abs(np.asarray(tris.v0)).max())
    atol = T_ATOL_ULPS * float(np.spacing(np.float32(scale)))
    err = np.abs(t1[same] - t2[same])
    bad = err > T_RTOL * np.abs(t1[same]) + atol
    if bad.any():
        raise AssertionError(f"{label}: {int(bad.sum())} agreeing hits differ "
                             f"in t beyond rtol {T_RTOL} + atol {atol:.3g}; "
                             f"worst {float(err.max()):.3g}")
    return flips, int((~keep).sum())


def phase_kernel(scenes, n_rays=FULL_RAYS, make_kernel=None,
                 chunks=JNP_CHUNKS, iters=ITERS, seed=0):
    """Phase b: the kernel against intersect_jnp on every query kind, then
    stand-alone times.  Returns {scene: {"kernel_s": .., "jnp_s": {chunk:
    s}, "best_chunk": ..}}."""
    import jax
    import jax.numpy as jnp
    from hermespy_rt_tpu.ops.intersect import intersect_jnp
    from hermespy_rt_tpu.ops.intersect_pallas import make_pallas_intersect
    make_kernel = make_kernel or make_pallas_intersect
    out = {}
    for name, (_, tris) in scenes.items():
        T = tris.v0.shape[0]
        o_np, d_np = random_rays(tris, n_rays, seed)
        o, d = jnp.asarray(o_np), jnp.asarray(d_np)
        kern = make_kernel(tris)
        chunk0 = min(c for c in chunks)
        ref = jax.jit(lambda o, d, ex=None: intersect_jnp(
            o, d, tris, chunk_size=chunk0, exclude=ex))
        t0 = time.perf_counter()
        kn = jax.jit(lambda o, d: kern(o, d))
        jax.block_until_ready(kn(o, d))
        log(f"[b] {name}: T={T} rays={n_rays} kernel compile+first call "
            f"{time.perf_counter() - t0:.2f} s")

        t1, i1 = ref(o, d)
        t2, i2 = kn(o, d)
        fl, _ = compare_queries(tris, o_np, d_np, t1, i1, t2, i2,
                                label=f"{name} nearest")
        hits = int((np.asarray(i1) >= 0).sum())
        log(f"[b] {name} nearest: hits={hits} flips={fl}")

        ex = jnp.asarray(i1)                 # exclude the nearest -> 2nd hit
        t1e, i1e = ref(o, d, ex)
        t2e, i2e = jax.jit(lambda o, d, e: kern(o, d, exclude=e))(o, d, ex)
        fl, _ = compare_queries(tris, o_np, d_np, t1e, i1e, t2e, i2e,
                                label=f"{name} exclude")
        log(f"[b] {name} exclude: flips={fl}")

        rng = np.random.default_rng(seed + 1)
        tm_np = rng.uniform(0.0, 2.0 * float(np.median(
            np.asarray(t1)[np.asarray(i1) >= 0])), n_rays).astype(np.float32)
        tm = jnp.asarray(tm_np)
        within = (np.asarray(i1) >= 0) & (np.asarray(t1) <= tm_np)
        t1m = np.where(within, np.asarray(t1), np.inf)
        i1m = np.where(within, np.asarray(i1), -1)
        t2m, i2m = jax.jit(lambda o, d, m: kern(o, d, t_max=m))(o, d, tm)
        fl, nb = compare_queries(tris, o_np, d_np, t1m, i1m, t2m, i2m,
                                 t_max=tm_np, label=f"{name} t_max")
        log(f"[b] {name} t_max: hits={int(within.sum())} flips={fl} "
            f"range-boundary flips={nb}")

        # whole dead blocks (every third span of n/256 rays) and scattered
        # dead rays; only live rays are compared (dead results unspecified)
        span = max(n_rays // 256, 1)
        live_np = (((np.arange(n_rays) // span) % 3) != 0) & (
            rng.uniform(size=n_rays) > 0.25)
        t2l, i2l = jax.jit(lambda o, d, lv: kern(o, d, live=lv))(
            o, d, jnp.asarray(live_np))
        fl, _ = compare_queries(tris, o_np, d_np, t1, i1, t2l, i2l,
                                mask=live_np, label=f"{name} live")
        log(f"[b] {name} live: live={int(live_np.sum())} flips={fl}")

        t2a, i2a = jax.jit(lambda o, d, m: kern(o, d, t_max=m, any_hit=True))(
            o, d, tm)
        t2a, i2a = np.asarray(t2a), np.asarray(i2a)
        if ((i2a >= 0) & ~(t2a <= tm_np)).any():
            raise AssertionError(f"{name} any-hit: a hit beyond t_max")
        # any-hit may name any qualifying blocker, so only the blocked flag
        # is compared: rays where it differs are hit<->miss flips
        differ = (i2a >= 0) != (i1m >= 0)
        fl, nb = compare_queries(tris, o_np, d_np, t1m, i1m, t2a, i2a,
                                 mask=differ, t_max=tm_np,
                                 label=f"{name} any-hit")
        log(f"[b] {name} any-hit: blocked={int((i2a >= 0).sum())} "
            f"flips={fl} range-boundary flips={nb}")

        k_s, _ = time_call(kn, o, d, iters=iters)
        res = {"kernel_s": k_s, "jnp_s": {}}
        log(f"[b] {name} time kernel nearest: {k_s * 1e3:.3f} ms "
            f"({n_rays / k_s / 1e6:.1f} Mrays/s)")
        for c in chunks:
            c = min(c, n_rays)
            if c * T * 12 > JNP_CHUNK_BYTES:
                log(f"[b] {name} time intersect_jnp chunk={c}: skipped, "
                    f"[chunk, T, 3] f32 = {c * T * 12 / 2**30:.1f} GiB")
                continue
            f = jax.jit(lambda o, d, c=c: intersect_jnp(o, d, tris,
                                                        chunk_size=c))
            s, _ = time_call(f, o, d, iters=iters)
            res["jnp_s"][c] = s
            log(f"[b] {name} time intersect_jnp chunk={c}: {s * 1e3:.3f} ms "
                f"({n_rays / s / 1e6:.1f} Mrays/s)")
        res["best_chunk"] = min(res["jnp_s"], key=res["jnp_s"].get)
        out[name] = res
    return out


# ----------------------------------------------------------------- phase c

def grad_leaves(g):
    import jax
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]


def check_step_output(label, loss, grads):
    lv = float(loss)
    gl = np.concatenate([x.ravel() for x in grad_leaves(grads)])
    if not np.isfinite(lv):
        raise AssertionError(f"{label}: loss {lv} is not finite")
    if not np.isfinite(gl).all():
        raise AssertionError(f"{label}: non-finite material gradients")
    if not (gl != 0).any():
        raise AssertionError(f"{label}: material gradients are all zero")
    return lv


def run_step(label, tris, cfg, scene, nrx, iters=ITERS, intersect_fn=None):
    """Compile, time and check one step.  Returns a record dict."""
    import jax
    from hermespy_rt_tpu.materials import default_materials
    rx, tx = positions(scene, nrx)
    mats = default_materials()
    step = make_step(tris, cfg, rx, tx, intersect_fn)
    t0 = time.perf_counter()
    compiled = step.lower(mats).compile()
    compile_s = time.perf_counter() - t0
    dt, ((loss, aux), grads) = time_call(compiled, mats, iters=iters)
    lv = check_step_output(label, loss, grads)
    queries = queries_per_step(cfg, nrx, tx.shape[0])
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", -1)
    temp = compiled.memory_analysis().temp_size_in_bytes
    log(f"[c] {label}: compile {compile_s:.2f} s, step {dt * 1e3:.3f} ms, "
        f"{queries / dt / 1e6:.2f} Mq/s, loss {lv:.6g}, "
        f"peak_bytes_in_use {peak}, step temp bytes {temp}")
    return dict(label=label, compile_s=compile_s, step_s=dt,
                queries_per_s=queries / dt, loss=loss, grads=grads,
                aux=aux, peak_bytes=peak)


def phase_main_path(scenes, num_paths=FULL_RAYS, iters=ITERS,
                    intersect_fn_for=None):
    """Phase c.  ``intersect_fn_for(tris)`` overrides the config's backend
    policy (tests pass an interpret-mode kernel)."""
    fn = intersect_fn_for or (lambda tris: None)
    recs = {}
    street = scenes["street"][1]
    for nrx in (1, 4, 16):
        recs[f"street_nrx{nrx}"] = run_step(
            f"street nrx={nrx}", street, step_config("street", num_paths),
            "street", nrx, iters, fn(street))
    if "city" in scenes:
        city = scenes["city"][1]
        recs["city_nrx1"] = run_step(
            "city nrx=1", city, step_config("city", num_paths), "city", 1,
            iters, fn(city))
    # gathers on the street: the loss must be bit-equal (both fetch exact
    # table rows) and the gradients agree within 1e-5 of their max (the
    # backward scatter-adds sum the same terms in another order)
    g = {}
    for gather in ("take", "onehot"):
        g[gather] = run_step(
            f"street nrx=1 gather={gather}", street,
            step_config("street", num_paths, gather=gather), "street", 1,
            iters, fn(street))
    if float(g["take"]["loss"]) != float(g["onehot"]["loss"]):
        raise AssertionError(f"take vs onehot loss differ: "
                             f"{float(g['take']['loss'])!r} vs "
                             f"{float(g['onehot']['loss'])!r}")
    for a, b in zip(grad_leaves(g["take"]["grads"]),
                    grad_leaves(g["onehot"]["grads"])):
        tol = 1e-5 * max(float(np.abs(a).max()), 1e-30) + 1e-18
        if float(np.abs(a - b).max()) > tol:
            raise AssertionError("take vs onehot gradients differ beyond "
                                 "1e-5 of their max")
    log(f"[c] gather take {g['take']['step_s'] * 1e3:.3f} ms vs onehot "
        f"{g['onehot']['step_s'] * 1e3:.3f} ms: loss bit-equal, grads "
        f"within 1e-5 of max")
    recs.update({f"gather_{k}": v for k, v in g.items()})
    return recs


def phase_api(xml_path, num_paths=REF_RAYS):
    """The public entry points once each on the city's XML path."""
    import hermespy_rt_tpu as hrt
    rx, tx = positions("city", 1)
    res = hrt.trace(xml_path, rx, tx, config=hrt.TracerConfig(
        num_paths=num_paths, num_bounces=BOUNCES, parity="physical"))
    a = np.asarray(res.scatter.a_te)
    if a.shape != (1, 1, BOUNCES * num_paths) or not np.isfinite(a).all():
        raise AssertionError(f"hrt.trace: bad scatter gains {a.shape}")
    los, scat = hrt.compute_paths(xml_path, rx, tx, np.zeros_like(rx),
                                  np.zeros_like(tx), 3.0, 1, 1, num_paths,
                                  BOUNCES)
    b = np.asarray(scat.a_te)
    if b.shape != a.shape or not np.isfinite(b).all():
        raise AssertionError(f"hrt.compute_paths: bad gains {b.shape}")
    log(f"[c] api: hrt.trace nonzero={int((np.abs(a) > 0).sum())}, "
        f"hrt.compute_paths nonzero={int((np.abs(b) > 0).sum())} "
        f"of {b.size} slots, los shape {tuple(np.asarray(los.a_te).shape)}")


def phase_kernel_in_step(scenes, kernel_res, step_recs, num_paths=FULL_RAYS,
                         iters=3):
    """Phase b, in the step: the nrx=1 step with intersect_jnp at its best
    stand-alone ray_chunk, beside phase c's kernel step."""
    for name in scenes:
        tris = scenes[name][1]
        c = kernel_res[name]["best_chunk"]
        rec = run_step(f"{name} nrx=1 backend=jnp chunk={c}", tris,
                       step_config(name, num_paths, backend="jnp",
                                   ray_chunk=c), name, 1, iters)
        k = step_recs[f"{name}_nrx1"]["step_s"]
        log(f"[b] {name} in-step: kernel {k * 1e3:.3f} ms vs jnp "
            f"{rec['step_s'] * 1e3:.3f} ms ({rec['step_s'] / k:.2f}x)")


# ----------------------------------------------------------------- phase d

# Per-slot gains: rtol 1e-4 on all but 1e-3 of the slots — a ray whose hit
# sits on a triangle edge may flip between the kernel and jnp (f32 op
# order), which moves that ray's whole output; every other slot agrees to
# f32 rounding of the shading chain.
GAIN_RTOL, GAIN_BAD_FRAC = 1e-4, 1e-3
# Material gradients: element-wise rtol 1e-3, looser than the gains because
# each gradient sums over all paths, the flipped ones included.  No absolute
# floor: rows of materials the scene does not hold are exact zeros on both
# sides, and a row the scene holds must match to rtol however small it is.
GRAD_RTOL = 1e-3


def phase_reference(street, num_paths=REF_RAYS, intersect_fn=None):
    """Phase d: street nrx=4 step on the default device (the kernel on a
    GPU) against the jnp step on the CPU."""
    import jax
    from hermespy_rt_tpu.materials import default_materials
    assert_mostly_allclose = test_helpers().assert_mostly_allclose
    rx, tx = positions("street", 4)
    mats = default_materials()
    (l_g, (te_g, tm_g)), g_g = make_step(
        street, step_config("street", num_paths), rx, tx, intersect_fn)(mats)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        tris_c = jax.device_put(street, cpu)
        mats_c = jax.device_put(mats, cpu)
        (l_c, (te_c, tm_c)), g_c = make_step(
            tris_c, step_config("street", num_paths, backend="jnp"),
            rx, tx)(mats_c)
    for lab, a, b in (("a_te", te_c, te_g), ("a_tm", tm_c, tm_g)):
        assert_mostly_allclose(np.asarray(a), np.asarray(b), rtol=GAIN_RTOL,
                               max_bad_frac=GAIN_BAD_FRAC, label=lab)
    worst = 0.0
    for a, b in zip(grad_leaves(g_c), grad_leaves(g_g)):
        np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=0.0,
                                   err_msg="material gradient, gpu vs cpu")
        nz = a != 0
        if nz.any():
            rel = np.abs(a - b)[nz] / np.abs(a[nz])
            worst = max(worst, float(rel.max()))
    log(f"[d] street nrx=4 {num_paths} rays: gains rtol {GAIN_RTOL} on all "
        f"but {GAIN_BAD_FRAC} of slots, met; material grads element-wise "
        f"within rtol {worst:.3g} (<= {GRAD_RTOL}); loss gpu {float(l_g):.7g} "
        f"cpu {float(l_c):.7g}")


# ----------------------------------------------------------------- phase e

def phase_multi(city, num_paths=FULL_RAYS, devices=None,
                intersect_factory=None, shapes=((4, 1), (2, 2))):
    """Phase e: the sharded city step on a 4x1 and a 2x2 mesh against the
    same step on one device."""
    import jax
    import jax.numpy as jnp
    from hermespy_rt_tpu.materials import default_materials
    from hermespy_rt_tpu.parallel import default_mesh, trace_paths_sharded
    devices = devices or jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--multi needs 4 devices, have {len(devices)}")
    rx, tx = positions("city", 1)
    z1 = jnp.zeros((1, 3), jnp.float32)
    cfg = step_config("city", num_paths)
    mats = default_materials()

    def sharded_step(mesh):
        def loss(m):
            r = trace_paths_sharded(city, m, rx, tx, z1, z1,
                                    jnp.float32(3.0), cfg, mesh=mesh,
                                    intersect_factory=intersect_factory)
            return scatter_power(r), (r.scatter.a_te, r.scatter.a_tm,
                                      r.scatter.tau)
        return jax.jit(jax.value_and_grad(loss, has_aux=True))

    def single_step(m):
        from hermespy_rt_tpu.tracer import trace_paths
        fn = intersect_factory(city) if intersect_factory else None
        r = trace_paths(city, m, rx, tx, z1, z1, jnp.float32(3.0), cfg,
                        intersect_fn=fn)
        return scatter_power(r), (r.scatter.a_te, r.scatter.a_tm,
                                  r.scatter.tau)

    with jax.default_device(devices[0]):
        t0 = time.perf_counter()
        (l1, aux1), g1 = jax.jit(jax.value_and_grad(single_step,
                                                    has_aux=True))(mats)
        jax.block_until_ready(g1)
        log(f"[e] one device: loss {float(l1):.7g} "
            f"({time.perf_counter() - t0:.1f} s incl. compile)")
    for shape in shapes:
        mesh = default_mesh(*shape, devices=devices[:4])
        step = sharded_step(mesh)
        t0 = time.perf_counter()
        compiled = step.lower(mats).compile()
        comp = time.perf_counter() - t0
        dt, ((l4, aux4), g4) = time_call(compiled, mats, iters=3)
        if shape == (4, 1):
            for name, a, b in zip(("a_te", "a_tm", "tau"), aux1, aux4):
                if not np.array_equal(np.asarray(a), np.asarray(b)):
                    n = int((np.asarray(a) != np.asarray(b)).sum())
                    raise AssertionError(f"4x1 mesh: {name} differs from one "
                                         f"device in {n} slots")
            verdict = "per-slot outputs bit-equal"
        else:
            np.testing.assert_allclose(float(l4), float(l1), rtol=1e-5)
            for a, b in zip(grad_leaves(g1), grad_leaves(g4)):
                np.testing.assert_allclose(b, a, rtol=1e-5)
            verdict = "loss and gradients within rtol 1e-5"
        log(f"[e] mesh {shape[0]}x{shape[1]}: compile {comp:.2f} s, step "
            f"{dt * 1e3:.3f} ms, {verdict}")


# ------------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase (e)")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    dev, _ = phase_device()
    from hermespy_rt_tpu.utils import enable_compile_cache
    log(f"[a] compile cache: {enable_compile_cache()}")
    import jax
    with tempfile.TemporaryDirectory() as work:
        if args.multi:
            scenes = make_scenes(work, ("city",))
            phase_multi(scenes["city"][1])
        else:
            scenes = make_scenes(work)
            kres = phase_kernel(scenes)
            recs = phase_main_path(scenes)
            phase_kernel_in_step(scenes, kres, recs)
            phase_api(scenes["city"][0])
            phase_reference(scenes["street"][1])
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
