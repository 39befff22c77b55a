"""Test environment: run on the CPU with 8 virtual devices so sharding logic
is testable without several accelerators (SURVEY.md §4 plan).  Must run
before jax imports.  ``JAX_PLATFORMS`` set by the caller wins, which is how
the ``gpu``-marked tests run on a card (README, "Tests").
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache(monkeypatch):
    """Entry points turn on JAX's persistent compile cache in the checkout;
    tests must not write there."""
    monkeypatch.setattr("hermespy_rt_tpu.utils.enable_compile_cache",
                        lambda: "disabled in tests")


@pytest.fixture()
def rng():
    # function-scoped: each test gets a fresh, deterministic stream
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def street_tris(tmp_path_factory):
    """The generated street scene (224 triangles, canyon-class;
    benchmarks/config5_scene.py STREET)."""
    from config5_scene import STREET, make_city
    from hermespy_rt_tpu.scene import flatten_scene, load_scene
    xml = make_city(str(tmp_path_factory.mktemp("street")), **STREET)
    return flatten_scene(load_scene(xml))


@pytest.fixture()
def gpu():
    """Skips the test unless JAX's default device is a GPU (tests marked
    ``gpu`` run on the card; see README)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; default device is {dev.platform}")
    return dev
