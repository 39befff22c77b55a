"""chip_smoke.py's phases at tiny sizes on the CPU (the kernel in interpret
mode); the device check stays in ``main`` and refuses the CPU."""
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from hermespy_rt_tpu.ops.intersect_pallas import make_pallas_intersect  # noqa: E402


def _kernel(tris):
    return make_pallas_intersect(tris, block_rays=32, block_tris=32,
                                 interpret=True)


@pytest.fixture(scope="module")
def street(tmp_path_factory):
    return cs.make_scenes(str(tmp_path_factory.mktemp("smoke")),
                          ("street",))


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_without_gpu(capsys):
    import bench
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    assert '"metric"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Copied into a directory without the repository, the script exits
    non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_kernel_tiny(street):
    res = cs.phase_kernel(street, n_rays=1024, make_kernel=_kernel,
                          chunks=(256, 1024), iters=1)
    assert set(res["street"]["jnp_s"]) == {256, 1024}
    assert res["street"]["best_chunk"] in (256, 1024)
    assert res["street"]["kernel_s"] > 0


def test_phase_main_path_tiny(street):
    recs = cs.phase_main_path(street, num_paths=128, iters=1,
                              intersect_fn_for=_kernel)
    assert {"street_nrx1", "street_nrx4", "street_nrx16", "gather_take",
            "gather_onehot"} <= set(recs)
    q = recs["street_nrx16"]
    assert q["queries_per_s"] > 0 and q["compile_s"] > 0


def test_phase_reference_tiny(street):
    cs.phase_reference(street["street"][1], num_paths=256,
                       intersect_fn=_kernel(street["street"][1]))


def test_phase_api_tiny(street):
    cs.phase_api(street["street"][0], num_paths=128)


def test_phase_multi_tiny(street):
    """The sharded step on the 2x2 (rays x tris) mesh of four CPU devices
    against one device."""
    cs.phase_multi(street["street"][1], num_paths=128,
                   intersect_factory=_kernel, shapes=((2, 2),))


def test_last_line_contract(capsys, monkeypatch):
    """The final stdout line is exactly the JSON object a harness reads."""
    class Dev:
        platform, device_kind = "gpu", "Fake GPU"

    class Scenes(dict):
        def __getitem__(self, name):
            return ("scene.xml", None)

    monkeypatch.setattr(cs, "phase_device", lambda: (Dev(), "Fake, 1 W"))
    monkeypatch.setattr(cs, "make_scenes", lambda work, names=(): Scenes())
    for name in ("phase_kernel", "phase_main_path", "phase_kernel_in_step",
                 "phase_api", "phase_reference"):
        monkeypatch.setattr(cs, name, lambda *a, **k: None)
    assert cs.main([]) == 0
    obj = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "Fake GPU", "count": obj["device"]["count"]}}
    assert isinstance(obj["device"]["count"], int)
