"""Profiling, logging, checkpointing, NaN guard, audio stub tests."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from d3d12renderer_jax.audio.audio import AudioEngine, sine_synth
from d3d12renderer_jax.core import log as log_mod
from d3d12renderer_jax.core.profiling import (
    export_chrome_trace, kernel_report, profile_block, profile_kernels,
    profile_stat, resolve_frame, time_device,
)
from d3d12renderer_jax.utils.checkpoint import (
    CheckpointManager, load_pytree, nan_guard, save_pytree, tree_all_finite,
)


def test_profile_blocks_and_tree():
    with profile_block("frame"):
        with profile_block("physics"):
            time.sleep(0.002)
        with profile_block("render"):
            time.sleep(0.001)
    profile_stat("contacts", 42)
    profile_stat("contacts", 8)
    frame = resolve_frame()
    assert frame["stats"]["contacts"] == 50
    names = {e["name"] for e in frame["events"]}
    assert {"frame", "physics", "render"} <= names
    roots = frame["tree"]
    assert roots[0]["name"] == "frame"
    assert {c["name"] for c in roots[0]["children"]} == {"physics", "render"}


def test_chrome_trace_export(tmp_path):
    with profile_block("x"):
        pass
    p = str(tmp_path / "trace.json")
    frame = resolve_frame()
    export_chrome_trace(p, frames=[frame])
    doc = json.load(open(p))
    assert any(e["name"] == "x" for e in doc["traceEvents"])


def test_time_device():
    f = jax.jit(lambda x: x * 2 + 1)
    dt = time_device(f, jnp.ones(128), iters=3)
    assert dt > 0


def test_log_ring():
    log_mod.log_info("hello %d", 42)
    log_mod.log_warning("careful")
    msgs = log_mod.recent_messages(2)
    assert msgs[-2].message == "hello 42"
    assert msgs[-1].level == "warning"
    assert "test_observability" in msgs[-1].origin


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": jnp.arange(5.0), "b": {"c": jnp.ones((2, 2))}}
    p = str(tmp_path / "x.bin")
    save_pytree(p, tree)
    back = load_pytree(p)
    np.testing.assert_allclose(np.asarray(back["a"]), np.arange(5.0))

    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep=2)
    for step in range(4):
        mgr.save(step, {"step": jnp.array(step)}, metric=float(step % 3))
    assert mgr.latest_step() == 3
    assert int(mgr.latest()["step"]) == 3
    assert int(mgr.best()["step"]) == 2  # metric 2 was max
    files = os.listdir(str(tmp_path / "ckpts"))
    assert len([f for f in files if f.startswith("ckpt_")]) == 2


def test_nan_guard_rolls_back():
    def bad_step(state, scale):
        return state * scale

    guarded = jax.jit(nan_guard(bad_step))
    s0 = jnp.ones(4)
    s1, rolled = guarded(s0, 2.0)
    assert not bool(rolled)
    np.testing.assert_allclose(np.asarray(s1), 2.0)
    s2, rolled2 = guarded(s1, jnp.nan)
    assert bool(rolled2)
    np.testing.assert_allclose(np.asarray(s2), 2.0)  # rolled back


def test_kernel_report_roofline():
    """Per-kernel device timing (reference: dx_query.h timestamp heaps +
    dx_profiling.h:25 per-frame resolve): XLA cost analysis x measured
    device time -> achieved GFLOP/s + utilization."""
    a = jnp.ones((256, 256), jnp.float32)

    rep = kernel_report(lambda x: x @ x, a, iters=5)
    # 256^3 MACs = 2*256^3 = 33.5 MFLOP; cost analysis must be in that decade.
    assert 1e7 < rep["flops"] < 1e8
    assert rep["device_s_per_call"] > 0 and rep["compile_s"] > 0
    assert rep["achieved_gflops"] > 0
    # The CPU has no published peaks: the roofline shares stay unset
    # rather than divided by made-up numbers.
    assert rep["platform"] == "cpu"
    assert rep["flops_utilization"] is None
    assert rep["hbm_utilization"] is None

    reports = profile_kernels({"matmul": (lambda x: x @ x, (a,)),
                               "add": (lambda x: x + x, (a,))}, iters=3)
    assert set(reports) == {"matmul", "add"}
    # An elementwise add moves ~3 buffers and does ~1 flop/elem: it must be
    # far more bandwidth-bound than the matmul.
    assert (reports["add"]["achieved_gflops"]
            < reports["matmul"]["achieved_gflops"])


def test_audio_engine_events():
    eng = AudioEngine()
    eng.set_listener((0, 0, 0))
    h = eng.play_sound_3d("impact.wav", position=(2.0, 0.0, 0.0), volume=1.0)
    far = eng.play_sound_3d("impact.wav", position=(20.0, 0.0, 0.0))
    assert eng.effective_volume(h.id) > eng.effective_volume(far.id)
    eng.set_submix_volume("sfx", 0.5)
    assert abs(eng.effective_volume(h.id) - 0.5 / (1 + 0.25 * 4)) < 1e-6
    h.stop()
    assert h.id not in eng.active_voices()
    eng.set_reverb("cave")
    kinds = [e["event"] for e in eng.events]
    assert kinds.count("play") == 2 and "stop" in kinds and "reverb" in kinds
    synth = eng.play_synth(sine_synth(220.0))
    assert synth.id in eng.active_voices()


def test_audio_mixdown_wav(tmp_path):
    """Offline mixdown: events -> stereo buffer -> WAV roundtrip
    (reference: the XAudio2 source->submix->master graph, audio/channel.cpp,
    rendered offline since no device is in scope)."""
    import wave as wave_mod

    from d3d12renderer_jax.audio.mixdown import mixdown, write_wav

    eng = AudioEngine()
    eng.set_listener((0, 0, 0), forward=(0, 0, -1))
    eng.play_synth(sine_synth(440.0), volume=0.5)
    # 3D voice to the listener's LEFT (forward -z => right = (-1, 0, 0)).
    eng.play_sound_3d("left_cue.wav", position=(3.0, 0.0, 0.0), volume=1.0)
    eng.advance(0.25)
    h = eng.play_synth(sine_synth(880.0), volume=0.4)
    eng.advance(0.25)
    h.stop()
    sr = 22050
    buf = mixdown(eng, duration=1.0, sample_rate=sr)
    assert buf.shape == (sr, 2)
    assert np.isfinite(buf).all()
    rms = float(np.sqrt((buf ** 2).mean()))
    assert rms > 1e-3, "mix should not be silent"
    # The +x 3D cue must bias one channel (constant-power pan).
    lr = np.sqrt((buf ** 2).mean(0))
    assert abs(lr[0] - lr[1]) / max(lr.max(), 1e-9) > 0.02
    # The 880 Hz voice exists only in [0.25, 0.5): that window is louder
    # than the same-length window after its stop.
    w1 = float(np.abs(buf[int(0.3 * sr):int(0.45 * sr)]).mean())
    w2 = float(np.abs(buf[int(0.55 * sr):int(0.7 * sr)]).mean())
    assert w1 > w2

    # Reverb lengthens the tail: a voice stopped at 0.2 s leaves silence
    # dry, but echo energy with the cave comb.
    eng_t = AudioEngine()
    ht = eng_t.play_synth(sine_synth(440.0), volume=0.8)
    eng_t.advance(0.2)
    ht.stop()
    dry = mixdown(eng_t, duration=1.0, sample_rate=sr)
    eng_t.set_reverb("cave")
    wet = mixdown(eng_t, duration=1.0, sample_rate=sr)
    t_dry = float(np.abs(dry[int(0.5 * sr):]).mean())
    t_wet = float(np.abs(wet[int(0.5 * sr):]).mean())
    assert t_dry < 1e-6 and t_wet > 10 * max(t_dry, 1e-9)

    path = str(tmp_path / "mix.wav")
    write_wav(path, buf, sr)
    with wave_mod.open(path, "rb") as w:
        assert w.getnchannels() == 2
        assert w.getframerate() == sr
        assert w.getnframes() == sr

    # A real PCM wav on disk is decoded (not placeholder-toned): write one,
    # play it, and check its frequency survives the mix.
    tone = np.sin(2 * np.pi * 330.0 * np.arange(sr) / sr) * 0.9
    src_path = str(tmp_path / "src.wav")
    write_wav(src_path, np.stack([tone, tone], -1).astype(np.float32), sr)
    eng2 = AudioEngine()
    eng2.play_sound_2d(src_path, volume=1.0)
    buf2 = mixdown(eng2, duration=0.5, sample_rate=sr)
    spec = np.abs(np.fft.rfft(buf2[:, 0]))
    peak_hz = float(np.argmax(spec)) / 0.5
    assert abs(peak_hz - 330.0) < 10.0, f"decoded tone at {peak_hz} Hz"


def test_collision_impact_sounds(tmp_path):
    """Physics collision-begin events drive 3D impact-synth voices and the
    mixdown has energy only after the first impact (reference: impact-sound
    callbacks, application.cpp:231-240)."""
    import jax
    import numpy as np

    from d3d12renderer_jax.audio.audio import AudioEngine, impact_synth
    from d3d12renderer_jax.audio.mixdown import mixdown, write_wav
    from d3d12renderer_jax.physics.builder import SceneBuilder
    from d3d12renderer_jax.physics.step import physics_step
    from d3d12renderer_jax.physics.types import PhysicsSettings

    b = SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0)
    body = b.add_body(position=(0.0, 1.6, 0.0))
    b.add_sphere_collider(body, 0.5, restitution=0.1)
    arch, state = b.finalize()
    settings = PhysicsSettings()
    step = jax.jit(lambda s, pa: physics_step(arch, s, settings, 1 / 60,
                                              num_substeps=2,
                                              collect_events=True,
                                              prev_active=pa))

    eng = AudioEngine()
    eng.set_listener((0.0, 1.0, -4.0), forward=(0, 0, 1))
    prev = None
    impacts = []
    speeds = []
    for f in range(60):
        state, contacts, ev = step(state, prev)
        prev = ev.active
        begin = np.asarray(ev.begin)
        for p, s in zip(np.asarray(contacts.point[:, 0])[begin],
                        np.asarray(ev.approach_speed)[begin]):
            t = f / 60.0
            impacts.append(t)
            speeds.append(float(s))
            eng.advance(t - eng.clock)
            eng.play_synth(impact_synth(float(s)), "sfx",
                           volume=min(1.0, 0.25 + float(s) / 10.0),
                           position=tuple(map(float, p)))

    # Free fall from 1.6 m to radius 0.5 -> impact ~ sqrt(2*1.1/9.8) ~ 0.47 s.
    assert impacts, "sphere drop produced no collision-begin event"
    assert 0.3 < impacts[0] < 0.6
    # Per-substep event collection reports the real pre-solve impact speed
    # (~g*t ~ 4.6 m/s), not the post-solve residual.
    assert speeds[0] > 3.0, speeds
    buf = mixdown(eng, 1.2)
    sr = 44100
    pre = np.abs(buf[: int((impacts[0] - 0.05) * sr)]).max()
    post = np.abs(buf[int(impacts[0] * sr): int((impacts[0] + 0.2) * sr)]).max()
    assert pre < 1e-6 and post > 0.01, (pre, post)
    out = tmp_path / "impacts.wav"
    write_wav(str(out), buf)
    assert out.stat().st_size > 44


def test_device_peaks_h100_from_data_sheet():
    from d3d12renderer_jax.core.profiling import device_peaks

    peaks = device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["bf16_flops"] == 989e12
    assert peaks["tf32_flops"] == 495e12
    assert peaks["fp32_flops"] == 67e12
    assert peaks["hbm_gbps"] == 3350.0


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "NVIDIA H200",
                                  "cpu", ""])
def test_device_peaks_unknown_kind_raises(kind):
    """No device gets assumed peaks: anything not in the table is an
    error."""
    from d3d12renderer_jax.core.profiling import device_peaks

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)
