"""Command-line entry points.

Capability parity with the reference's executables: ``hrt-convert`` replaces
``scene_fromSionna.elf`` (/root/reference/src/scene_fromSionna.c:461-488),
``hrt-trace`` replaces the C test driver workflow
(/root/reference/test/test.c) with npz output and optional PNG ray rendering
instead of the blocking GLUT window, and ``hrt-bench`` runs the throughput
harness.  The reference has no config system (SURVEY.md §5); these provide
the typed-flag surface.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

__all__ = ["convert_main", "trace_main", "bench_main"]


def convert_main(argv=None):
    p = argparse.ArgumentParser(
        prog="hrt-convert",
        description="Convert a Sionna/Mitsuba XML scene (or PLY) to HRT.")
    p.add_argument("scene", help="input scene (.xml, .ply or .hrt)")
    p.add_argument("-o", "--output", default="scene.hrt",
                   help="output HRT path (default: scene.hrt, matching the "
                        "reference converter)")
    args = p.parse_args(argv)

    from .scene import load_scene, save_hrt
    scene = load_scene(args.scene)
    save_hrt(scene, args.output)
    print(json.dumps({"output": args.output, "num_meshes": scene.num_meshes,
                      "num_triangles": scene.num_triangles}))
    return 0


def trace_main(argv=None):
    p = argparse.ArgumentParser(
        prog="hrt-trace", description="Trace multipath channels in a scene.")
    p.add_argument("scene", help="scene file (.hrt, .xml, .ply)")
    p.add_argument("--tx", action="append", required=True,
                   help="TX position 'x,y,z' (repeatable)")
    p.add_argument("--rx", action="append", required=True,
                   help="RX position 'x,y,z' (repeatable)")
    p.add_argument("--tx-vel", action="append", default=None,
                   help="TX velocity 'x,y,z' (repeatable, default 0)")
    p.add_argument("--rx-vel", action="append", default=None,
                   help="RX velocity 'x,y,z' (repeatable, default 0)")
    p.add_argument("-f", "--frequency", type=float, default=3.0,
                   help="carrier frequency in GHz (default 3.0)")
    p.add_argument("-p", "--paths", type=int, default=10000)
    p.add_argument("-b", "--bounces", type=int, default=3)
    p.add_argument("--parity", choices=["reference", "physical"],
                   default="reference")
    p.add_argument("--backend", choices=["auto", "jnp", "pallas"],
                   default="auto")
    p.add_argument("-o", "--output", default=None, help="output .npz path")
    p.add_argument("--render", default=None,
                   help="render scene + rays to this image file")
    p.add_argument("--metrics", default=None, help="append metrics JSONL here")
    args = p.parse_args(argv)

    def parse_vecs(items, n=None):
        if items is None:
            return np.zeros((n, 3), np.float32)
        return np.array([[float(v) for v in it.split(",")] for it in items],
                        np.float32)

    tx = parse_vecs(args.tx)
    rx = parse_vecs(args.rx)
    txv = parse_vecs(args.tx_vel, len(tx))
    rxv = parse_vecs(args.rx_vel, len(rx))

    import hermespy_rt_tpu as hrt
    from .utils import enable_compile_cache
    from .utils.profiling import log_metrics, time_trace

    enable_compile_cache()

    cfg = hrt.TracerConfig(num_paths=args.paths, num_bounces=args.bounces,
                           parity=args.parity, backend=args.backend)
    scene = hrt.load_scene(args.scene)
    result = hrt.trace(scene, rx, tx, rxv, txv, args.frequency, config=cfg)

    los_a_te = np.asarray(result.los.a_te)
    scat_a_te = np.asarray(result.scatter.a_te)
    summary = {
        "scene": args.scene,
        "num_rx": len(rx), "num_tx": len(tx),
        "num_paths": args.paths, "num_bounces": args.bounces,
        "los_active": int(np.sum(np.abs(los_a_te) > 0)),
        "scatter_nonzero": int(np.sum(np.abs(scat_a_te) > 0)),
        "scatter_slots": int(scat_a_te.size),
    }

    if args.output:
        np.savez(
            args.output,
            los_a_te=los_a_te,
            los_a_tm=np.asarray(result.los.a_tm),
            los_tau=np.asarray(result.los.tau),
            los_freq_shift=np.asarray(result.los.freq_shift),
            los_directions_rx=np.asarray(result.los.directions_rx),
            los_directions_tx=np.asarray(result.los.directions_tx),
            scatter_a_te=scat_a_te,
            scatter_a_tm=np.asarray(result.scatter.a_tm),
            scatter_tau=np.asarray(result.scatter.tau),
            scatter_freq_shift=np.asarray(result.scatter.freq_shift),
            scatter_directions_rx=np.asarray(result.scatter.directions_rx),
            scatter_directions_tx=np.asarray(result.scatter.directions_tx),
        )
        summary["output"] = args.output

    if args.render:
        from .viz import save_rays_figure
        save_rays_figure(scene, result.rays_scatter, args.render)
        summary["render"] = args.render

    if args.metrics:
        import jax

        def run(_):
            r = hrt.trace(scene, rx, tx, rxv, txv, args.frequency, config=cfg)
            return r.scatter.tau
        stats = time_trace(run, 0, num_paths=args.paths,
                           num_bounces=args.bounces, num_rx=len(rx),
                           num_tx=len(tx))
        log_metrics(stats, extra={"scene": args.scene}, path=args.metrics)
        summary["queries_per_s"] = stats.queries_per_s

    print(json.dumps(summary))
    return 0


def bench_main(argv=None):
    p = argparse.ArgumentParser(
        prog="hrt-bench",
        description="Throughput of the fwd+bwd trace step on one GPU "
                    "(see bench.py).")
    p.add_argument("--scene", choices=["street", "city"], default="street")
    p.add_argument("--paths", type=int, default=1 << 20)
    p.add_argument("--bounces", type=int, default=3)
    p.add_argument("--rx", type=int, default=1, help="number of receivers")
    args = p.parse_args(argv)
    import importlib.util
    import os
    import tempfile
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "hrt_bench", os.path.join(root, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dev, smi = mod.gpu_device()
    from .utils import enable_compile_cache
    enable_compile_cache()
    with tempfile.TemporaryDirectory() as work:
        tris = mod.make_scenes(work, (args.scene,))[args.scene][1]
        value, dt, queries = mod.measure_step(
            tris, args.scene, num_paths=args.paths,
            num_bounces=args.bounces, num_rx=args.rx)
    print(json.dumps({"queries_per_s": value, "step_s": dt,
                      "queries": queries, "device": dev.device_kind,
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(trace_main())
