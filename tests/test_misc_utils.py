"""Hot reload, undo stack, policy export, generated geometry."""

import pytest
import os

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.learning.export import (
    export_policy_header, policy_forward_np,
)
from d3d12renderer_jax.learning.networks import ActorCritic
from d3d12renderer_jax.render.geometry_gen import (
    koch_fractal_3d, koch_snowflake, metaballs_mesh,
)
from d3d12renderer_jax.utils.hot_reload import KernelRegistry
from d3d12renderer_jax.utils.undo import UndoStack


def test_kernel_registry_invalidation(tmp_path):
    import sys
    mod_dir = tmp_path / "pkg"
    mod_dir.mkdir()
    (mod_dir / "__init__.py").write_text("")
    (mod_dir / "k.py").write_text("def f(x):\n    return x * 2\n")
    sys.path.insert(0, str(tmp_path))
    try:
        reg = KernelRegistry()
        reg.register("double", "pkg.k", "f")
        assert float(reg("double", jnp.array(3.0))) == 6.0
        v0 = reg.version("double")
        (mod_dir / "k.py").write_text("def f(x):\n    return x * 3\n")
        reg.invalidate_module("pkg.k")
        assert reg.version("double") == v0 + 1
        assert float(reg("double", jnp.array(3.0))) == 9.0
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("pkg.k", None)
        sys.modules.pop("pkg", None)


def test_undo_stack_toggle_semantics():
    doc = {"v": 0}

    def toggle(old):
        cur = doc["v"]
        doc["v"] = old
        return cur

    stack = UndoStack()
    doc["v"] = 1
    stack.push("set 1", 0, toggle)   # stores the PREVIOUS value
    doc["v"] = 2
    stack.push("set 2", 1, toggle)

    assert stack.undo() == "set 2" and doc["v"] == 1
    assert stack.undo() == "set 1" and doc["v"] == 0
    assert stack.undo() is None
    assert stack.redo() == "set 1" and doc["v"] == 1
    assert stack.redo() == "set 2" and doc["v"] == 2
    assert stack.redo() is None
    assert stack.verify()
    # A new push after undo truncates the redo branch.
    stack.undo()
    doc["v"] = 7
    stack.push("set 7", 1, toggle)
    assert stack.redo_name is None


@pytest.mark.slow
def test_policy_export_matches_forward(tmp_path):
    net = ActorCritic(action_dim=5)
    obs = np.random.default_rng(0).normal(size=(3, 11)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    mean, _, _ = net.apply(params, jnp.asarray(obs))
    np_mean = policy_forward_np(params, obs)
    np.testing.assert_allclose(np_mean, np.asarray(mean), atol=1e-5)

    path = str(tmp_path / "network.h")
    export_policy_header(params, path)
    text = open(path).read()
    assert "#define HIDDEN_LAYER_SIZE 128" in text
    assert "policyWeights1[128][11]" in text
    assert "actionWeights[5][128]" in text


def test_koch_snowflake():
    k0 = koch_snowflake(0)
    k2 = koch_snowflake(2)
    assert len(k0) == 3 and len(k2) == 48
    assert np.isfinite(k2).all()
    mesh = koch_fractal_3d(2)
    assert mesh.indices.max() < len(mesh.positions)


def test_metaballs_isosurface():
    centers = [[0.0, 0.0, 0.0], [0.7, 0.0, 0.0]]
    radii = [0.5, 0.4]
    mesh = metaballs_mesh(centers, radii, resolution=24, extent=1.6)
    assert len(mesh.positions) > 50
    assert mesh.indices.max() < len(mesh.positions)
    # Vertices lie near the isosurface: field value ~ 0.
    p = mesh.positions
    f = sum(r * r / np.maximum(((p - np.asarray(c)) ** 2).sum(-1), 1e-9)
            for c, r in zip(centers, radii)) - 1.0
    assert np.abs(f).mean() < 0.35
    # Both blobs merged: x extent spans both centers.
    assert p[:, 0].min() < -0.3 and p[:, 0].max() > 1.0


def test_persistent_compilation_cache_enabled():
    """Importing the package enables the persistent XLA compile cache (the
    pipeline-state-cache analog, dx_pipeline.cpp:412) in the checkout's
    fixed .jax_cache, unless JAX_COMPILATION_CACHE_DIR names one."""
    import os

    import jax

    import d3d12renderer_jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # JAX reads the variable itself; the package sets nothing
    assert (jax.config.jax_compilation_cache_dir
            == d3d12renderer_jax.CHECKOUT_CACHE_DIR)


@pytest.mark.parametrize("env", [None, "", "/elsewhere/xla"])
def test_compile_cache_dir_rule(monkeypatch, env):
    """Set: the package leaves the cache to JAX.  Unset or empty: a fixed
    directory inside the checkout, the same on every call."""
    import os

    import d3d12renderer_jax as pkg

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    got = pkg.compile_cache_dir()
    if env:
        assert got is None
    else:
        root = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
        assert got == os.path.join(root, ".jax_cache")
        assert got == pkg.compile_cache_dir()
