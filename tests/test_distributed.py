"""Multi-process jax.distributed coverage:
``initialize_distributed`` is exercised by two REAL processes on CPU, and the
cross-process mesh traces the same values as single-process.

Runs each worker as a subprocess (jax.distributed cannot re-initialize inside
the test process).  Skips cleanly if the rendezvous port is unavailable.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ.pop("JAX_PLATFORMS", None)
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

sys.path.insert(0, {repo!r})
from hermespy_rt_tpu.parallel.sharding import initialize_distributed
from hermespy_rt_tpu.parallel import default_mesh, trace_paths_sharded
from hermespy_rt_tpu.config import TracerConfig
from hermespy_rt_tpu.materials import default_materials
from hermespy_rt_tpu.scene import flatten_scene, simple_reflector_scene

pid = int(sys.argv[1])
initialize_distributed(coordinator_address={coord!r}, num_processes=2,
                       process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()   # 2 local x 2 processes

tris = flatten_scene(simple_reflector_scene())
mats = default_materials()
cfg = TracerConfig(num_paths=256, num_bounces=2, backend="jnp",
                   keep_rays=False)
rx = jnp.asarray([[0.1, -0.05, 0.4]], jnp.float32)
tx = jnp.asarray([[0.0, 0.1, 0.6]], jnp.float32)
z = jnp.zeros((1, 3), jnp.float32)
mesh = default_mesh(num_ray_shards=4)
res = trace_paths_sharded(tris, mats, rx, tx, z, z, jnp.float32(3.0), cfg,
                          mesh=mesh)
p = float(jnp.sum(jnp.abs(res.scatter.a_te) ** 2)
          + jnp.sum(jnp.abs(res.scatter.a_tm) ** 2))
g = jax.grad(lambda m: (lambda r: jnp.sum(jnp.abs(r.scatter.a_te) ** 2))(
    trace_paths_sharded(tris, m, rx, tx, z, z, jnp.float32(3.0), cfg,
                        mesh=mesh)) * 1e9)(mats)
gsum = float(sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(g)))
print("RESULT " + json.dumps({{"pid": pid, "power": p, "gsum": gsum}}),
      flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_trace(tmp_path):
    # (no pytest-timeout plugin in this image; the communicate(timeout=540)
    # below is the real guard)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = f"localhost:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo, coord=coord))

    env = dict(os.environ)
    env["PYTHONPATH"] = repo + ":" + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(script), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"

    results = []
    for out in outs:
        line = next(l for l in out.splitlines() if l.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))

    # both processes see identical (replicated-output) power and grad sums
    assert results[0]["power"] == pytest.approx(results[1]["power"], rel=0)
    assert results[0]["gsum"] == pytest.approx(results[1]["gsum"], rel=0)
    assert results[0]["power"] > 0
    assert results[0]["gsum"] > 0

    # and they match the single-process value
    import jax
    import jax.numpy as jnp
    from hermespy_rt_tpu.config import TracerConfig
    from hermespy_rt_tpu.materials import default_materials
    from hermespy_rt_tpu.scene import flatten_scene, simple_reflector_scene
    from hermespy_rt_tpu.tracer import trace_paths

    tris = flatten_scene(simple_reflector_scene())
    cfg = TracerConfig(num_paths=256, num_bounces=2, backend="jnp",
                       keep_rays=False)
    rx = jnp.asarray([[0.1, -0.05, 0.4]], jnp.float32)
    tx = jnp.asarray([[0.0, 0.1, 0.6]], jnp.float32)
    z = jnp.zeros((1, 3), jnp.float32)
    res = trace_paths(tris, default_materials(), rx, tx, z, z,
                      jnp.float32(3.0), cfg)
    p1 = float(jnp.sum(jnp.abs(res.scatter.a_te) ** 2)
               + jnp.sum(jnp.abs(res.scatter.a_tm) ** 2))
    np.testing.assert_allclose(results[0]["power"], p1, rtol=1e-6)
