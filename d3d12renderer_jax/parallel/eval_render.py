"""Sharded evaluation rendering over a device mesh.

The reference evaluates policies by rendering the scene in its single-GPU
editor (src/editor/editor.cpp play mode); here an eval frame is
path-traced data-parallel instead: the pixel rays are sharded along the
mesh's data axis, every device traces only its scanline band, and one
`all_gather` (tiled) reassembles the full frame on every device —
the frame-sized traffic crosses the interconnect once, at the very end (SURVEY.md
§5.8 collective strategy).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..render.camera import Camera, generate_rays
from ..render.pathtracer import PathTracerSettings, Scene, trace_sample
from .data_parallel import AXIS


def pathtrace_sharded(scene: Scene, camera: Camera, width: int, height: int,
                      mesh: Mesh,
                      settings: PathTracerSettings = PathTracerSettings(),
                      spp: int = 1,
                      key: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Path-trace an (H, W, 3) frame with rays sharded over `mesh`.

    Every device traces rows*width/n rays; the returned frame is fully
    replicated (out_specs=P()) via a tiled all_gather of the per-shard
    radiance bands.  Exact — equals the single-device render for the same
    key up to reduction order."""
    n = mesh.devices.size
    key = key if key is not None else jax.random.PRNGKey(0)
    r = height * width
    pad = (-r) % n

    def shard_fn(o_s, d_s, k):
        k = k[0]

        def body(i, acc):
            return acc + trace_sample(scene, settings, o_s, d_s,
                                      jax.random.fold_in(k, i))

        rad = jax.lax.fori_loop(
            0, spp, body, jnp.zeros((o_s.shape[0], 3))) / spp
        return jax.lax.all_gather(rad, AXIS, axis=0, tiled=True)

    k_cam, k_trace = jax.random.split(key)
    f_num = settings.f_number if settings.use_thin_lens else 0.0
    o, d = generate_rays(camera, width, height, key=k_cam,
                         f_number=f_num, focal_length=settings.focal_length)
    o = jnp.pad(o, ((0, pad), (0, 0)))
    d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    # Per-shard trace keys: fold in the shard index so bands decorrelate.
    shard_keys = jax.random.split(k_trace, n)

    frame = jax.jit(
        jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS)),
            out_specs=P(),
            check_vma=False,
        )
    )(o, d, shard_keys)
    return frame[:r].reshape(height, width, 3)
