"""Audio engine API (host-side event model; no audio device in scope).

Reference: src/audio/ — XAudio2 voices (channel.h:59), 2D/3D sounds with
pitch/volume, per-type submix voices, reverb presets (audio.h:12-50,
reverb.h), procedural synth sources (synth.h), async streaming (sound.cpp).

This build keeps the full API shape — play_sound_2d/3d, listener, submix
volumes, reverb presets, synth sources — as an event-producing engine so
gameplay systems (e.g. collision-sound callbacks, application.cpp:231-240)
behave identically; events can be consumed by an external mixer or logged
(SURVEY.md §2.73: host-side stub API, keep API shape)."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# Reverb presets (reference: audio/reverb.h preset table).
REVERB_PRESETS = (
    "off", "default", "generic", "forest", "cave", "hangar", "city",
    "mountains", "underwater",
)

SOUND_TYPES = ("music", "sfx", "ambient", "voice")  # submix channels


@dataclass
class SoundHandle:
    id: int
    engine: "AudioEngine"

    def stop(self):
        self.engine.stop(self.id)

    def set_volume(self, v: float):
        self.engine._update(self.id, volume=v)

    def set_pitch(self, p: float):
        self.engine._update(self.id, pitch=p)


@dataclass
class _Voice:
    path: Optional[str]
    sound_type: str
    volume: float
    pitch: float
    looping: bool
    position: Optional[Tuple[float, float, float]]  # None = 2D
    synth: Optional[Callable] = None
    start_time: float = field(default_factory=time.time)
    playing: bool = True


class AudioEngine:
    """reference: audio/audio.h master engine + channel management."""

    def __init__(self):
        self.master_volume = 1.0
        self.submix_volumes: Dict[str, float] = {t: 1.0 for t in SOUND_TYPES}
        self.reverb = "off"
        self.listener_position = (0.0, 0.0, 0.0)
        self.listener_forward = (0.0, 0.0, -1.0)
        self._voices: Dict[int, _Voice] = {}
        self._next = 0
        self.events: List[dict] = []
        # Deterministic timeline for offline mixdown: advance() moves the
        # clock; play/stop/update events are stamped with it.
        self.clock = 0.0

    def advance(self, dt: float):
        """Advance the engine timeline (one sim/frame tick)."""
        self.clock += float(dt)

    # -- playback (reference: play2DSound/play3DSound) -----------------------

    def play_sound_2d(self, path: str, sound_type="sfx", volume=1.0,
                      pitch=1.0, looping=False) -> SoundHandle:
        return self._play(_Voice(path, sound_type, volume, pitch, looping, None))

    def play_sound_3d(self, path: str, position, sound_type="sfx", volume=1.0,
                      pitch=1.0, looping=False) -> SoundHandle:
        return self._play(_Voice(path, sound_type, volume, pitch, looping,
                                 tuple(position)))

    def play_synth(self, synth_fn: Callable[[np.ndarray], np.ndarray],
                   sound_type="sfx", volume=1.0, pitch=1.0,
                   position=None) -> SoundHandle:
        """Procedural source (reference: audio/synth.h sine/noise synths).
        With `position`, the voice is 3D (distance attenuation + pan) like
        play_sound_3d."""
        pos = tuple(position) if position is not None else None
        return self._play(_Voice(None, sound_type, volume, pitch, False, pos,
                                 synth=synth_fn))

    def _play(self, voice: _Voice) -> SoundHandle:
        vid = self._next
        self._next += 1
        self._voices[vid] = voice
        self.events.append({
            "event": "play", "id": vid, "t": self.clock, "path": voice.path,
            "type": voice.sound_type, "volume": voice.volume,
            "pitch": voice.pitch, "position": voice.position,
            "effective_volume": self.effective_volume(vid, voice),
        })
        return SoundHandle(vid, self)

    def stop(self, vid: int):
        if vid in self._voices and self._voices[vid].playing:
            self._voices[vid].playing = False
            self.events.append({"event": "stop", "id": vid,
                                "t": self.clock})

    def _update(self, vid: int, **kw):
        v = self._voices.get(vid)
        if v:
            for k, val in kw.items():
                setattr(v, k, val)
            self.events.append({"event": "update", "id": vid,
                                "t": self.clock, **kw})

    # -- mixing model (reference: submix voices per sound type + 3D pan) ------

    def set_submix_volume(self, sound_type: str, volume: float):
        self.submix_volumes[sound_type] = volume

    def set_reverb(self, preset: str):
        assert preset in REVERB_PRESETS, f"unknown reverb {preset!r}"
        self.reverb = preset
        self.events.append({"event": "reverb", "preset": preset})

    def set_listener(self, position, forward=(0.0, 0.0, -1.0)):
        self.listener_position = tuple(position)
        self.listener_forward = tuple(forward)

    def effective_volume(self, vid: int, voice: Optional[_Voice] = None) -> float:
        """3D attenuation x submix x master (reference: channel.cpp 3D calc)."""
        v = voice or self._voices[vid]
        vol = v.volume * self.submix_volumes[v.sound_type] * self.master_volume
        if v.position is not None:
            d = math.dist(v.position, self.listener_position)
            vol *= 1.0 / (1.0 + 0.25 * d * d)
        return vol

    def active_voices(self) -> List[int]:
        return [i for i, v in self._voices.items() if v.playing]


def sine_synth(frequency: float = 440.0, sample_rate: int = 44100):
    """reference: audio/synth.h sine synth source."""

    def gen(t: np.ndarray) -> np.ndarray:
        return np.sin(2 * np.pi * frequency * t).astype(np.float32)

    gen.sample_rate = sample_rate
    return gen


def impact_synth(speed: float, seed: int = 0, sample_rate: int = 44100):
    """Collision 'thud': a decaying noise burst over a low sine, pitched and
    shortened with impact speed (the synth source for collision-sound
    callbacks; reference plays wav assets from its collision-begin hook,
    application.cpp:231-240, via audio/synth.h-style sources)."""
    rng = np.random.default_rng(seed)
    speed = float(speed)
    decay = 14.0 + 2.0 * speed
    f0 = 70.0 + 12.0 * min(speed, 8.0)

    def gen(t: np.ndarray) -> np.ndarray:
        noise = rng.standard_normal(t.shape).astype(np.float32)
        env = np.exp(-decay * t).astype(np.float32)
        body = np.sin(2 * np.pi * f0 * t).astype(np.float32)
        return env * (0.65 * body + 0.35 * noise)

    gen.sample_rate = sample_rate
    gen.duration = 0.4
    return gen
