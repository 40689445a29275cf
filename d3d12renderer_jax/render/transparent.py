"""General transparent pass: per-pixel back-to-front alpha compositing.

Reference: src/rendering/render_pass.h:100 — the transparent render pass
sorts its command buffer by a float depth key and draws back-to-front after
the opaque pass.  Design: each transparent object is intersected by the
camera rays independently (its own small BVH), producing per-pixel fragment
(depth, color, alpha); fragments are then composited back-to-front PER PIXEL
— a fixed K-step selection over the per-object depth stack, which is
stricter than the reference's per-object ordering (no popping when objects
interleave)."""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax.numpy as jnp

from ..core import maths as m
from . import bvh as bvh_mod
from .pathtracer import Sky


class TransparentObject(NamedTuple):
    bvh: object            # render.bvh.BVH of this object alone
    color: Tuple[float, float, float]
    alpha: float


def transparent_pass(color, gb, camera, objects: List[TransparentObject],
                     sky: Optional[Sky] = None, sun_lit=None):
    """Composite transparent objects over the opaque color buffer.

    color (H, W, 3); gb the opaque GBuffer (depth test source).  Returns the
    blended color."""
    if not objects:
        return color
    h, w = gb.depth.shape
    d = m.noz(gb.world_pos - camera.position)
    o = jnp.broadcast_to(camera.position, d.shape)
    t_opaque = jnp.where(
        gb.hit, jnp.linalg.norm(gb.world_pos - camera.position + 1e-9,
                                axis=-1), jnp.inf)

    to_sun = m.noz(sky.sun_direction) if sky is not None else jnp.array(
        [0.3, 0.8, 0.5])
    sun_irr = (sky.sun_radiance * 0.05) if sky is not None else 3.0

    ts, rgbs, alphas = [], [], []
    for obj in objects:
        res = bvh_mod.closest_hit(obj.bvh, o.reshape(-1, 3), d.reshape(-1, 3))
        n, _, _, _ = bvh_mod.hit_attributes(obj.bvh, res)
        ndl = jnp.maximum(jnp.sum(n * to_sun, -1), 0.0)
        if sky is not None:
            up = jnp.clip(n[:, 1:2] * 0.5 + 0.5, 0.0, 1.0)
            ambient = sky.horizon * (1 - up) + sky.zenith * up
        else:
            ambient = 0.3
        shade = jnp.asarray(obj.color) * (
            ndl[:, None] * sun_irr / jnp.pi + ambient * 0.5)
        t = jnp.where(res["hit"], res["t"], jnp.inf).reshape(h, w)
        t = jnp.where(t < t_opaque, t, jnp.inf)   # opaque depth test
        ts.append(t)
        rgbs.append(shade.reshape(h, w, 3))
        alphas.append(jnp.asarray(obj.alpha, jnp.float32))

    ts = jnp.stack(ts)                 # (K, H, W)
    rgbs = jnp.stack(rgbs)             # (K, H, W, 3)
    alphas = jnp.stack(alphas)         # (K,)

    out = color
    k = len(objects)
    for _ in range(k):                 # back-to-front selection composite
        far = jnp.where(jnp.isinf(ts), -jnp.inf, ts)
        i = jnp.argmax(far, axis=0)                       # (H, W)
        t_i = jnp.take_along_axis(ts, i[None], axis=0)[0]
        rgb_i = jnp.take_along_axis(rgbs, i[None, ..., None], axis=0)[0]
        a_i = alphas[i]
        valid = jnp.isfinite(t_i)
        out = jnp.where(valid[..., None],
                        out * (1 - a_i[..., None]) + rgb_i * a_i[..., None],
                        out)
        ts = jnp.where(jnp.arange(k)[:, None, None] == i[None], jnp.inf, ts)
    return out
