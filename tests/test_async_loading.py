"""Async asset loading (VERDICT r1 missing item 9; reference:
src/geometry/mesh.h:22-43 job-chained multi-mesh loads with load states).
"""

import threading
import time

import numpy as np

from d3d12renderer_jax.assets.async_loader import (
    AsyncLoader, LoadState, load_model_async,
)


def test_load_states_and_result():
    loader = AsyncLoader(workers=2)
    gate = threading.Event()

    def slow_load(path):
        gate.wait(5.0)
        return {"path": path, "data": 42}

    h = loader.submit("a.bin", slow_load)
    assert h.state == LoadState.LOADING
    assert h.result is None
    gate.set()
    out = h.wait(5.0)
    assert h.state == LoadState.LOADED
    assert out["data"] == 42
    loader.shutdown()


def test_failed_load_records_error():
    loader = AsyncLoader(workers=1)

    def bad(path):
        raise ValueError("corrupt")

    h = loader.submit("bad.bin", bad)
    try:
        h.wait(5.0)
        assert False, "expected failure"
    except RuntimeError:
        pass
    assert h.state == LoadState.FAILED
    assert isinstance(h.error, ValueError)
    loader.shutdown()


def test_multi_load_concurrency_and_dedup():
    loader = AsyncLoader(workers=4)
    active = []
    peak = []
    lock = threading.Lock()

    def tracked(path):
        with lock:
            active.append(path)
            peak.append(len(active))
        time.sleep(0.05)
        with lock:
            active.remove(path)
        return path

    handles = loader.submit_many([f"m{i}" for i in range(4)], tracked)
    results = loader.wait_all(handles, 10.0)
    assert sorted(results) == [f"m{i}" for i in range(4)]
    assert max(peak) > 1, "loads did not overlap"

    # A second submit of the same path returns the SAME handle (dedup).
    again = loader.submit("m0", tracked)
    assert again is handles[0]
    loader.shutdown()


def test_on_done_chaining():
    loader = AsyncLoader(workers=1)
    chained = threading.Event()
    seen = {}

    def done(handle):
        seen["state"] = handle.state
        chained.set()

    loader.submit("x", lambda p: 7, on_done=done)
    assert chained.wait(5.0)
    assert seen["state"] == LoadState.LOADED
    loader.shutdown()


def test_load_model_async_obj(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n")
    h = load_model_async(str(obj))
    asset = h.wait(30.0)
    assert len(asset.meshes) == 1
    assert asset.meshes[0].positions.shape[0] >= 3
