"""CPU/device profiling: named blocks, stat counters, chrome-trace export.

Reference: src/core/cpu_profiling.h:14 (RAII blocks into a lock-free event
ring, per-frame resolve into a block tree + flame chart, CPU_PROFILE_STAT
counters) and src/dx/dx_profiling.h:25 (GPU timestamps resolved per frame).
Here: host blocks wrap Python orchestration; device timing wraps jitted
calls with block_until_ready; deep kernel profiles delegate to
jax.profiler traces.  Events export as chrome://tracing JSON.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_tls = threading.local()
_lock = threading.Lock()
_events: List[dict] = []       # chrome trace events
_frame_stats: Dict[str, float] = {}
_enabled = True


def set_enabled(on: bool):
    global _enabled
    _enabled = on


def _stack() -> List[str]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


@contextmanager
def profile_block(name: str):
    """Named timing block (reference: CPU_PROFILE_BLOCK)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter_ns()
    _stack().append(name)
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        _stack().pop()
        with _lock:
            _events.append({
                "name": name, "ph": "X",
                "ts": t0 / 1000.0, "dur": (t1 - t0) / 1000.0,
                "pid": 0, "tid": threading.get_ident() % 100000,
            })


def profile_stat(name: str, value: float):
    """Per-frame stat counter (reference: CPU_PROFILE_STAT)."""
    if _enabled:
        with _lock:
            _frame_stats[name] = _frame_stats.get(name, 0.0) + value


def resolve_frame() -> Dict[str, Any]:
    """Collect and clear this frame's events+stats (reference:
    cpuProfilingResolveTimeStamps at frame start, main.cpp:57)."""
    global _events, _frame_stats
    with _lock:
        ev, _events = _events, []
        st, _frame_stats = _frame_stats, {}
    tree = _build_tree(ev)
    return {"events": ev, "stats": st, "tree": tree}


def _build_tree(events: List[dict]) -> List[dict]:
    """Nest events into a block tree per thread (reference:
    profiling_internal.h:30-55)."""
    by_tid: Dict[int, List[dict]] = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        by_tid.setdefault(e["tid"], []).append(e)
    roots = []
    for tid, evs in by_tid.items():
        stack: List[dict] = []
        for e in evs:
            node = {"name": e["name"], "ts": e["ts"], "dur": e["dur"],
                    "children": []}
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            (stack[-1]["children"] if stack else roots).append(node)
            stack.append(node)
    return roots


def export_chrome_trace(path: str, frames: Optional[List[dict]] = None):
    """Write accumulated events as chrome://tracing / Perfetto JSON."""
    with _lock:
        ev = list(_events)
    if frames:
        for f in frames:
            ev.extend(f["events"])
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def time_device(fn, *args, iters: int = 10, warmup: int = 1, **kw) -> float:
    """Steady-state seconds/call of a jitted function (the GPU-timestamp
    equivalent: host wall clock around block_until_ready)."""
    import jax

    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace for XProf (deep per-kernel timing)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# Published peaks per device, keyed by `device_kind`, for roofline shares.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates
# without sparsity, at the full 700 W power limit.  The reference's GPU
# timestamp queries (dx_query.h, dx_profiling.h:25) answer "how long did
# this pass take on-device" — here the same question is answered per
# compiled XLA program, plus what the hardware ceiling for it was.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_gbps": 3350.0,
        "hbm_bytes": 80e9,
    },
}


def device_peaks(device_kind: str) -> dict:
    """Peaks of `device_kind`; a device that is not in DEVICE_PEAKS is an
    error, never a default."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       "add them to DEVICE_PEAKS with their source") from None


def card_line() -> str:
    """`name, power.limit` of each NVIDIA card, one line each, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them.  A card may run below its published peaks when its power limit is
    below the maximum, so every device number is kept beside this line."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _dispatch_floor(device) -> float:
    """Seconds for an empty dispatch + sync round trip; cached per device."""
    import jax
    import jax.numpy as jnp

    key = str(device)
    if key not in _dispatch_floor._cache:
        tiny = jax.jit(lambda x: x + 1.0)
        x = jnp.zeros((8,))
        jax.block_until_ready(tiny(x))
        t0 = time.perf_counter()
        for _ in range(10):
            jax.block_until_ready(tiny(x))
        _dispatch_floor._cache[key] = (time.perf_counter() - t0) / 10
    return _dispatch_floor._cache[key]


_dispatch_floor._cache = {}


def kernel_report(fn, *args, iters: int = 10, warmup: int = 2, **kw) -> dict:
    """Per-program device timing + roofline: compile the function, time the
    steady state (dispatch-floor corrected), and combine with XLA's own cost
    analysis into achieved GFLOP/s, GB/s, and shares of the device's
    published peaks (fp32 FLOP/s, HBM bytes/s).  The shares are None on the
    CPU, which has no entry in DEVICE_PEAKS; any other device missing from
    it raises.

    Replaces the reference's per-pass GPU timestamp resolve
    (dx_profiling.h:25) with the XLA-native equivalent: the compiled
    executable is the unit that is timed.
    """
    import jax

    t0 = time.perf_counter()
    lowered = jax.jit(fn).lower(*args, **kw)
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0

    cost = compiled.cost_analysis() or {}
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))

    out = None
    for _ in range(warmup):
        out = compiled(*args, **kw)
    jax.block_until_ready(out)
    # Auto-scale iterations until the measurement window is long enough for
    # pipelined dispatch overhead to amortize (sub-floor kernels otherwise
    # read as ~zero after the floor subtraction).
    t0 = time.perf_counter()
    done = 0
    while True:
        for _ in range(iters):
            out = compiled(*args, **kw)
        jax.block_until_ready(out)
        done += iters
        elapsed = time.perf_counter() - t0
        if elapsed > 0.3 or done >= 1000:
            break
        iters = min(iters * 4, 1000 - done)
    wall_s = elapsed / done

    device = jax.devices()[0]
    # Subtract the dispatch floor, but never attribute more than half the
    # wall time to it — tiny kernels pipeline under the floor.
    device_s = wall_s - min(_dispatch_floor(device), 0.5 * wall_s)
    peaks = (None if device.platform == "cpu"
             else device_peaks(device.device_kind))
    gflops = flops / device_s / 1e9
    gbps = bytes_accessed / device_s / 1e9
    return {
        "compile_s": compile_s,
        "wall_s_per_call": wall_s,
        "device_s_per_call": device_s,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "achieved_gflops": gflops,
        "achieved_gbps": gbps,
        "flops_utilization": (None if peaks is None
                              else gflops * 1e9 / peaks["fp32_flops"]),
        "hbm_utilization": (None if peaks is None
                            else gbps / peaks["hbm_gbps"]),
        "platform": device.platform,
        "device_kind": device.device_kind,
    }


def profile_kernels(named, iters: int = 10) -> dict:
    """kernel_report over {name: (fn, args)}; records each as a profile stat
    and returns {name: report}.  The text table is the CLI stand-in for the
    reference's per-pass GPU timing bars."""
    reports = {}
    for name, (fn, fargs) in named.items():
        rep = kernel_report(fn, *fargs, iters=iters)
        reports[name] = rep
        profile_stat(f"kernel/{name}/device_ms", rep["device_s_per_call"] * 1e3)
    return reports
