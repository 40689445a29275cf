"""Offline audio mixdown: engine event log -> stereo WAV.

Reference: the XAudio2 mixing graph — source voices -> per-type submix
voices -> mastering voice, with 3D pan/attenuation computed per channel
(src/audio/channel.cpp) and reverb as a master effect (src/audio/reverb.h).
This build has no audio device, so the same graph is evaluated offline:
`mixdown` renders the engine's stamped timeline (AudioEngine.clock /
advance()) into an (N, 2) float buffer and `write_wav` emits PCM16.

Sources: synth callables (audio.sine_synth), real PCM WAV files (stdlib
`wave`, the zlib-style no-new-deps rule), or — when a path does not exist
on disk — a deterministic placeholder tone derived from the path hash, so
event logs recorded without assets still render audibly distinct cues.
"""

from __future__ import annotations

import math
import os
import wave
from typing import Optional, Tuple

import numpy as np

from .audio import REVERB_PRESETS, AudioEngine

# preset -> (delay seconds, feedback) for the mastering comb; tuned for
# audible character, mirroring the reference preset table's density/decay
# ordering (audio/reverb.h).
_REVERB = {
    "off": None,
    "default": (0.029, 0.25),
    "generic": (0.031, 0.30),
    "forest": (0.041, 0.20),
    "cave": (0.071, 0.55),
    "hangar": (0.089, 0.50),
    "city": (0.023, 0.22),
    "mountains": (0.107, 0.35),
    "underwater": (0.013, 0.60),
}
assert set(_REVERB) == set(REVERB_PRESETS)


def _load_wav(path: str, sr: int, dur_s: float) -> Optional[np.ndarray]:
    try:
        with wave.open(path, "rb") as w:
            n = w.getnframes()
            raw = w.readframes(n)
            width = w.getsampwidth()
            ch = w.getnchannels()
            fsr = w.getframerate()
    except (FileNotFoundError, OSError, wave.Error):
        return None
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        return None
    x = x.reshape(-1, ch).mean(-1)
    if fsr != sr:  # linear resample to the mix rate
        ti = np.arange(int(len(x) * sr / fsr)) * (fsr / sr)
        i0 = np.minimum(ti.astype(np.int64), len(x) - 1)
        i1 = np.minimum(i0 + 1, len(x) - 1)
        x = x[i0] * (1 - (ti - i0)) + x[i1] * (ti - i0)
    return x.astype(np.float32)


def _placeholder_tone(path: str, sr: int, dur_s: float) -> np.ndarray:
    """Deterministic decaying tone from the path hash (missing asset)."""
    h = hash(path) & 0xFFFF
    freq = 220.0 * 2.0 ** ((h % 24) / 12.0)
    t = np.arange(int(sr * min(dur_s, 1.5))) / sr
    return (np.sin(2 * np.pi * freq * t) * np.exp(-3.0 * t)).astype(np.float32)


def _pan_gains(position, listener_pos, listener_fwd) -> Tuple[float, float]:
    """Constant-power stereo pan from the lateral offset to the listener."""
    if position is None:
        return math.sqrt(0.5), math.sqrt(0.5)
    f = np.asarray(listener_fwd, np.float64)
    f = f / max(np.linalg.norm(f), 1e-9)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(f, up)
    rn = np.linalg.norm(right)
    right = right / rn if rn > 1e-9 else np.array([1.0, 0.0, 0.0])
    to = np.asarray(position, np.float64) - np.asarray(listener_pos, np.float64)
    d = np.linalg.norm(to)
    side = float(np.dot(to, right) / d) if d > 1e-9 else 0.0  # [-1, 1]
    ang = (side + 1.0) * (math.pi / 4.0)                       # 0..pi/2
    return math.cos(ang), math.sin(ang)


def mixdown(engine: AudioEngine, duration: float,
            sample_rate: int = 44100) -> np.ndarray:
    """Render the engine's event timeline to an (N, 2) float32 buffer.

    Each play event starts its voice at its stamped time; stop events end
    it; volume/pitch updates take effect from their stamp; looping sources
    wrap.  Voice gain = volume x submix x master x distance attenuation
    (audio.effective_volume model); 3D voices get constant-power pan; a
    preset comb reverb runs on the master bus."""
    sr = sample_rate
    n = int(round(duration * sr))
    out = np.zeros((n, 2), np.float32)

    stops = {e["id"]: e.get("t", 0.0) for e in engine.events
             if e["event"] == "stop"}
    updates: dict = {}
    for e in engine.events:
        if e["event"] == "update":
            updates.setdefault(e["id"], []).append(e)

    for e in engine.events:
        if e["event"] != "play":
            continue
        vid = e["id"]
        t0 = float(e.get("t", 0.0))
        if t0 >= duration:
            continue
        voice = engine._voices.get(vid)
        end = float(stops.get(vid, duration))
        seg = max(0.0, min(end, duration) - t0)
        if seg <= 0.0:
            continue

        # Source samples (mono, mix rate).
        pitch = float(e.get("pitch", 1.0))
        if voice is not None and voice.synth is not None:
            ssr = getattr(voice.synth, "sample_rate", sr)
            t = np.arange(int(seg * ssr)) * (pitch / ssr)
            src = np.asarray(voice.synth(t), np.float32)
            if ssr != sr and len(src):
                idx = np.minimum((np.arange(int(seg * sr))
                                  * (ssr / sr)).astype(np.int64),
                                 len(src) - 1)
                src = src[idx]
        else:
            src = _load_wav(e.get("path") or "", sr, seg)
            if src is None:
                src = _placeholder_tone(e.get("path") or "", sr, seg)
            if pitch != 1.0 and len(src):
                idx = (np.arange(int(len(src) / pitch)) * pitch)
                i0 = np.minimum(idx.astype(np.int64), len(src) - 1)
                src = src[i0]
        if not len(src):
            continue

        nseg = int(seg * sr)
        looping = bool(voice.looping) if voice is not None else False
        if looping:
            reps = int(np.ceil(nseg / len(src)))
            src = np.tile(src, reps)[:nseg]
        else:
            src = src[:nseg]

        # Gain automation: piecewise-constant volume from update events.
        vol = np.full(len(src), float(e.get("volume", 1.0)), np.float32)
        for ue in updates.get(vid, []):
            if "volume" in ue:
                k = int(max(0.0, float(ue.get("t", 0.0)) - t0) * sr)
                vol[min(k, len(vol)):] = float(ue["volume"])

        stype = e.get("type", "sfx")
        gain = (engine.submix_volumes.get(stype, 1.0)
                * engine.master_volume)
        pos = e.get("position")
        if pos is not None:
            d = math.dist(pos, engine.listener_position)
            gain *= 1.0 / (1.0 + 0.25 * d * d)
        gl, gr = _pan_gains(pos, engine.listener_position,
                            engine.listener_forward)

        i0 = int(t0 * sr)
        i1 = min(i0 + len(src), n)
        chunk = src[: i1 - i0] * vol[: i1 - i0] * gain
        out[i0:i1, 0] += chunk * gl
        out[i0:i1, 1] += chunk * gr

    rv = _REVERB.get(engine.reverb)
    if rv is not None:
        delay, fb = rv
        from scipy.signal import lfilter

        k = max(1, int(delay * sr))
        # comb y[i] = x[i] + fb * y[i-k] == IIR with a = [1, 0..0, -fb]
        a = np.zeros(k + 1)
        a[0] = 1.0
        a[k] = -fb
        out = lfilter([1.0], a, out, axis=0).astype(np.float32)
        out *= 1.0 / (1.0 + fb)

    peak = np.abs(out).max()
    if peak > 1.0:                   # soft master limiter
        out /= peak
    return out


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 44100):
    """PCM16 stereo WAV via the stdlib `wave` module."""
    s = np.asarray(samples, np.float32)
    if s.ndim == 1:
        s = np.stack([s, s], -1)
    pcm = (np.clip(s, -1.0, 1.0) * 32767.0).astype(np.int16)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(s.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
