"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to run
without a GPU.  On the card the same phases run at full size."""

import json

import pytest

import chip_smoke


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs an NVIDIA GPU" in out.err


def test_main_four_cards_refuses_without_gpu(capsys):
    assert chip_smoke.main(["--four-cards"]) != 0
    assert capsys.readouterr().out == ""


def test_check_raises_on_failure():
    assert chip_smoke.check(True, "fine") == "fine"
    with pytest.raises(AssertionError, match="broken"):
        chip_smoke.check(False, "broken")


def test_loco_phases_tiny(capsys):
    res = chip_smoke.phase_loco_env(num_envs=4, steps=30)
    band = chip_smoke.ROLLOUT_REWARD_BAND
    assert band[0] <= res["mean_reward"] <= band[1]
    res = chip_smoke.phase_ppo(num_envs=4, rollout_steps=4, iterations=2,
                               minibatches=1, epochs=1)
    assert len(res["losses"]) == 2
    out = capsys.readouterr().out
    for name in ("loco_env[4 envs x 30 steps, ", "ppo[4 envs x 4 steps]"):
        assert f"phase {name}" in out


def test_physics_phases_tiny():
    assert chip_smoke.phase_stack(bodies=8, batch=2, substeps=4)["min_y"] > -0.2
    assert chip_smoke.phase_vehicle(batch=2, steps=3)["drove_m"] > 0.0


def test_render_phases_tiny():
    luma = chip_smoke.phase_render_frame(64, 32, detail=0.2,
                                         shadow_resolution=64)["luma"]
    assert chip_smoke.FRAME_LUMA_BAND[0] <= luma <= chip_smoke.FRAME_LUMA_BAND[1]
    assert chip_smoke.phase_pathtrace(64, 32, detail=0.2, depth=1)["rays"] > 0


def test_four_card_phases_tiny():
    """The --four-cards path on four of the test process's virtual CPU
    devices."""
    res = chip_smoke.phase_distributed_ppo(
        n_devices=4, num_envs=2, rollout_steps=2, iterations=1,
        minibatches=1, epochs=1)
    assert len(res["losses"]) == 1
    res = chip_smoke.phase_sharded_pathtrace(n_devices=4, width=32, height=16,
                                             detail=0.2, depth=1)
    assert res["off_fraction"] <= 1e-3


def test_last_line_format(monkeypatch, capsys):
    """With a (stubbed) GPU the script ends on the one JSON line the card
    run is read by."""
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    import jax
    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    from d3d12renderer_jax.core import profiling
    monkeypatch.setattr(profiling, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    for name in ("phase_loco_env", "phase_ppo",
                 "phase_stack", "phase_vehicle", "phase_render_frame",
                 "phase_pathtrace"):
        monkeypatch.setattr(chip_smoke, name, lambda **kw: {})
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
