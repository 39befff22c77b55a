"""The one device policy (tracer.resolve_backend) and the compile-cache
placement: no hidden fallbacks, no platform guessing."""
import os

import jax
import numpy as np
import pytest

import hermespy_rt_tpu.tracer as tracer
from hermespy_rt_tpu.config import TracerConfig
from hermespy_rt_tpu.scene import box_scene, flatten_scene
from hermespy_rt_tpu.utils import cache


@pytest.mark.parametrize("backend,platform,want", [
    ("auto", "cpu", "jnp"),
    ("jnp", "cpu", "jnp"),
    ("auto", "gpu", "pallas"),
    ("pallas", "gpu", "pallas"),
    ("jnp", "gpu", "jnp"),
])
def test_resolve_backend(monkeypatch, backend, platform, want):
    monkeypatch.setattr(tracer.jax, "default_backend", lambda: platform)
    assert tracer.resolve_backend(TracerConfig(backend=backend)) == want


def test_pallas_backend_refused_without_gpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        tracer.resolve_backend(TracerConfig(backend="pallas"))
    rx = np.array([[1.0, 2.0, 1.5]], np.float32)
    tx = np.array([[-2.0, -1.0, 2.5]], np.float32)
    z = np.zeros((1, 3), np.float32)
    from hermespy_rt_tpu.materials import default_materials
    with pytest.raises(RuntimeError, match="needs a GPU"):
        tracer.trace_paths(flatten_scene(box_scene()), default_materials(),
                           rx, tx, z, z, 3.0,
                           TracerConfig(num_paths=64, num_bounces=1,
                                        backend="pallas"))


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_other_platforms_are_an_error(monkeypatch, platform):
    monkeypatch.setattr(tracer.jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="no intersection backend"):
        tracer.resolve_backend(TracerConfig())


def test_auto_on_cpu_selects_jnp_closure():
    fn = tracer._select_intersect(flatten_scene(box_scene()), TracerConfig())
    assert fn.__name__ == "jnp_fn"


def test_compile_cache_env_wins(monkeypatch):
    seen = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: seen.append(a))
    assert cache.enable_compile_cache() == "/elsewhere/cache"
    assert seen == []                 # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    seen = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: seen.append(a))
    path = cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert seen == [("jax_compilation_cache_dir", path)]
