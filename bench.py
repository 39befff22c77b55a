#!/usr/bin/env python
"""Headline benchmark: forward+backward intersection-query throughput of the
training step on one GPU (BASELINE.json north star).

Metric: queries/s where "queries" = Möller–Trumbore nearest-hit queries, the
SURVEY.md §3.2 cost model (num_bounces * num_tx * num_paths * (1 + num_rx)
queries per trace), measured over the jitted forward+backward step of
``benchmarks/train_step.py::make_step`` (loss = scatter gain power,
gradients w.r.t. the full material table) at 2^20 paths and 3 bounces.

Prints one JSON line per row — the generated street at nrx = 1 (the
headline), 4 and 16, and the generated city at nrx = 1 — each naming the
device and the card's power limit.  Exits non-zero without a GPU.
"""
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

from train_step import (BOUNCES, FULL_RAYS, ITERS, gpu_device,  # noqa: E402
                        make_scenes, make_step, positions, queries_per_step,
                        step_config, time_call)

ROWS = (("street", 1), ("street", 4), ("street", 16), ("city", 1))


def measure_step(tris, scene="street", num_paths=FULL_RAYS,
                 num_bounces=BOUNCES, num_rx=1, iters=ITERS):
    """Queries/s, seconds per step and queries per step of the fwd+bwd
    step on ``tris`` (one of the generated scenes)."""
    from hermespy_rt_tpu.materials import default_materials
    cfg = step_config(scene, num_paths, num_bounces=num_bounces)
    rx, tx = positions(scene, num_rx)
    mats = default_materials()
    compiled = make_step(tris, cfg, rx, tx).lower(mats).compile()
    dt, _ = time_call(compiled, mats, iters=iters)
    queries = queries_per_step(cfg, num_rx, tx.shape[0])
    return queries / dt, dt, queries


def main():
    dev, smi = gpu_device()
    from hermespy_rt_tpu.utils import enable_compile_cache
    enable_compile_cache()
    import jax
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()), card=smi)
    with tempfile.TemporaryDirectory() as work:
        scenes = make_scenes(work)
        for scene, nrx in ROWS:
            value, dt, queries = measure_step(scenes[scene][1], scene,
                                              num_rx=nrx)
            print(json.dumps({
                "metric": f"{scene}_fwd_bwd_queries_per_s_nrx{nrx}",
                "value": value, "unit": "queries/s", "step_s": dt,
                "queries": queries, "device": device}), flush=True)


if __name__ == "__main__":
    main()
