"""bench.py's legs at tiny sizes on the CPU, and its refusal to run without
a GPU.  The numbers are meaningless here; the shapes and checks are not."""

import sys

import pytest

import bench


def test_main_refuses_without_gpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bench.py", "--smoke"])
    assert bench.main() != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs an NVIDIA GPU" in out.err


def test_loco_and_physics_legs_tiny():
    loco = bench.bench_loco(batch=4, steps=4, steps_per_chunk=2)
    assert loco["value"] > 0 and loco["batch"] == 4
    phys = bench.bench_physics(batch=2, steps=2, bodies=8)
    assert phys["stack_ok"] and phys["stack_batch"] == 2
    assert phys["vehicle_steps_per_sec"] > 0


@pytest.mark.parametrize("leg, kwargs, keys", [
    (bench.bench_rays, dict(width=64, height=32, grid=(4, 6),
                            atrium_detail=0.2),
     ("ray_mrays_per_sec", "ray_mrays_per_sec_atrium")),
    (bench.bench_pt_e2e, dict(width=64, height=32, detail=0.2, depth=1),
     ("pt_mrays_e2e", "pt_e2e_rays_per_frame")),
    (bench.bench_raster_frame, dict(width=64, height=32, detail=0.2,
                                    shadow_resolution=64, frames=1),
     ("raster_1080p_atrium_ms", "raster_frame_mean")),
])
def test_render_legs_tiny(leg, kwargs, keys):
    out = leg(**kwargs)
    for k in keys:
        assert out[k] > 0, (k, out)
