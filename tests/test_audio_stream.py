"""Streaming audio mixer (audio/stream.py) vs the offline mixdown.

Reference behaviors pinned: chunked source streaming (sound.cpp's
submitSourceBuffer loop), bounded per-type voice pools with stealing
(channel.cpp:468), seamless master reverb across chunk boundaries."""

import wave

import numpy as np
import pytest

from d3d12renderer_jax.audio.audio import AudioEngine, sine_synth
from d3d12renderer_jax.audio.mixdown import mixdown, write_wav
from d3d12renderer_jax.audio.stream import (
    StreamingMixer, WavBlockReader, stream_to_wav,
)

SR = 8000  # small rate keeps the test fast


def _make_wav(path, freq=330.0, secs=1.0, sr=SR):
    t = np.arange(int(sr * secs)) / sr
    x = (np.sin(2 * np.pi * freq * t) * 0.5).astype(np.float32)
    write_wav(str(path), np.stack([x, x], -1), sr)
    return str(path)


def _render_stream(engine, duration, **kw):
    mixer = StreamingMixer(engine, SR, **kw)
    n = int(duration * SR)
    out = []
    while sum(len(b) for b in out) < n:
        out.append(mixer.render_block())
    return np.concatenate(out)[:n]


def test_stream_matches_mixdown_wav_and_synth(tmp_path):
    wav = _make_wav(tmp_path / "beep.wav")
    eng = AudioEngine()
    eng.play_sound_2d(wav, volume=0.8)
    eng.advance(0.25)
    h = eng.play_synth(sine_synth(440.0, SR), volume=0.4)
    eng.advance(0.5)
    h.set_volume(0.2)          # mid-timeline volume automation
    eng.advance(0.75)

    ref = mixdown(eng, 1.6, SR)
    out = _render_stream(eng, 1.6, block_frames=777)  # odd block size
    assert out.shape == ref.shape
    # Same timeline, same gains; resampler state carried across odd-sized
    # blocks must not drift.
    assert np.abs(out - ref).max() < 1e-4


def test_stream_reverb_seamless(tmp_path):
    wav = _make_wav(tmp_path / "ping.wav", secs=0.2)
    eng = AudioEngine()
    eng.set_reverb("cave")
    eng.play_sound_2d(wav)
    eng.advance(1.0)
    ref = mixdown(eng, 1.0, SR)
    out = _render_stream(eng, 1.0, block_frames=512)
    # The comb ring carried across 512-frame blocks must equal the offline
    # IIR bit-for-bit-ish (float accumulation differences only).
    assert np.abs(out - ref).max() < 1e-3


def test_block_reader_looping_and_eof(tmp_path):
    wav = _make_wav(tmp_path / "loop.wav", secs=0.1)
    rd = WavBlockReader(wav, SR, looping=True)
    a = rd.read(int(SR * 0.25))
    assert not rd.done
    # Looping: the second 0.1 s chunk repeats the first.
    n = int(SR * 0.1)
    assert np.abs(a[:n] - a[n:2 * n]).max() < 1e-4

    rd2 = WavBlockReader(wav, SR, looping=False)
    b = rd2.read(int(SR * 0.25))
    assert rd2.done
    assert np.abs(b[n + 8:]).max() == 0.0  # silence after EOF


def test_voice_stealing_cap():
    eng = AudioEngine()
    for i in range(6):
        eng.play_synth(sine_synth(200.0 + 50 * i, SR), volume=0.1 + 0.1 * i)
    eng.advance(0.2)
    mixer = StreamingMixer(eng, SR, block_frames=256, max_voices_per_type=3)
    mixer.render_block()
    assert mixer.active == 3
    assert mixer.stolen == 3


def test_stream_to_wav_long_timeline(tmp_path):
    """A 30 s timeline streams in O(block) memory and writes a valid WAV."""
    eng = AudioEngine()
    eng.play_synth(sine_synth(220.0, SR), volume=0.3)
    eng.advance(30.0)
    out = str(tmp_path / "long.wav")
    stats = stream_to_wav(eng, 30.0, out, SR, block_frames=2048)
    with wave.open(out, "rb") as w:
        assert w.getnframes() == 30 * SR
        assert w.getnchannels() == 2
    assert stats["peak"] > 0.05 and stats["stolen"] == 0


@pytest.mark.parametrize("pitch", [0.75, 1.5])
def test_stream_pitch(tmp_path, pitch):
    wav = _make_wav(tmp_path / "p.wav", freq=400.0, secs=0.5)
    eng = AudioEngine()
    eng.play_sound_2d(wav, pitch=pitch)
    eng.advance(0.5)
    out = _render_stream(eng, 0.5)
    # Dominant frequency scales with pitch.
    spec = np.abs(np.fft.rfft(out[: SR // 2, 0]))
    f = np.argmax(spec) * SR / (SR // 2)      # bin width = SR / window
    assert abs(f - 400.0 * pitch) < 15.0
