"""Render camera: projection, ray generation, TAA jitter.

Mirrors the reference camera model (reference: src/core/camera.h:61
render_camera — position/rotation/vFov/aspect, jittered projection for TAA;
thin-lens parameters from the path tracer settings
src/rendering/path_tracing.h:15-17 useThinLensCamera/fNumber/focalLength).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import maths as m

# Halton(2,3) sequence for TAA jitter (reference: src/core/camera.cpp
# jitter sequence).
def halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    while index > 0:
        f /= base
        r += f * (index % base)
        index //= base
    return r


@struct.dataclass
class Camera:
    position: jnp.ndarray     # (3,)
    rotation: jnp.ndarray     # (4,) quaternion; camera looks down -Z
    v_fov: float = struct.field(pytree_node=False, default=math.radians(60.0))
    aspect: float = struct.field(pytree_node=False, default=16.0 / 9.0)
    near: float = struct.field(pytree_node=False, default=0.1)
    far: float = struct.field(pytree_node=False, default=1000.0)


def look_at(eye, target, up=(0.0, 1.0, 0.0), **kw) -> Camera:
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    upv = np.asarray(up, np.float64)
    r = np.cross(f, upv)
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    # Camera basis: x=right, y=up, z=-forward.
    mat = np.stack([r, u, -f], axis=1)
    # Matrix -> quaternion.
    t = np.trace(mat)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        q = np.array([
            (mat[2, 1] - mat[1, 2]) / s,
            (mat[0, 2] - mat[2, 0]) / s,
            (mat[1, 0] - mat[0, 1]) / s,
            0.25 * s,
        ])
    else:
        i = int(np.argmax(np.diag(mat)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(max(mat[i, i] - mat[j, j] - mat[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (mat[j, i] + mat[i, j]) / s
        q[k] = (mat[k, i] + mat[i, k]) / s
        q[3] = (mat[k, j] - mat[j, k]) / s
    q /= np.linalg.norm(q)
    return Camera(position=jnp.asarray(eye, jnp.float32),
                  rotation=jnp.asarray(q, jnp.float32), **kw)


def generate_rays(
    camera: Camera,
    width: int,
    height: int,
    key: Optional[jnp.ndarray] = None,
    f_number: float = 0.0,
    focal_length: float = 1.0,
    offset=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Primary rays (origin (H*W,3), direction (H*W,3)).

    With `key`, sub-pixel positions are jittered per pixel (AA) and, if
    f_number > 0, origins sample a thin-lens aperture (reference path
    tracer DoF: path_tracing.h:15-17).  `offset` instead applies ONE
    sub-pixel offset to every pixel — the TAA-style per-frame jitter the
    rasterized primary path uses (its edge functions evaluate at a single
    sample position per frame)."""
    px = jnp.arange(width, dtype=jnp.float32)
    py = jnp.arange(height, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(px, py)
    if offset is not None:
        off = jnp.broadcast_to(
            jnp.asarray(offset, jnp.float32).reshape(1, 1, 2),
            (height, width, 2))
    elif key is not None:
        key, k1 = jax.random.split(key)
        off = jax.random.uniform(k1, (height, width, 2))
    else:
        off = jnp.full((height, width, 2), 0.5)
    ndc_x = (gx + off[..., 0]) / width * 2.0 - 1.0
    ndc_y = 1.0 - (gy + off[..., 1]) / height * 2.0
    tan_half = math.tan(camera.v_fov * 0.5)
    dir_cam = jnp.stack(
        [ndc_x * tan_half * camera.aspect, ndc_y * tan_half,
         -jnp.ones_like(ndc_x)], axis=-1
    ).reshape(-1, 3)
    d = m.quat_rotate(camera.rotation[None, :], dir_cam)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(camera.position, d.shape)

    if key is not None and f_number > 0.0:
        # Thin lens: offset origin on the aperture disc, refocus through the
        # focal plane.
        aperture = focal_length / f_number * 0.5
        k2, k3 = jax.random.split(key)
        r = jnp.sqrt(jax.random.uniform(k2, (d.shape[0],))) * aperture
        theta = jax.random.uniform(k3, (d.shape[0],)) * 2 * jnp.pi
        right = m.quat_rotate(camera.rotation[None, :],
                              jnp.array([[1.0, 0.0, 0.0]]))
        up = m.quat_rotate(camera.rotation[None, :], jnp.array([[0.0, 1.0, 0.0]]))
        offset = (right * (r * jnp.cos(theta))[:, None]
                  + up * (r * jnp.sin(theta))[:, None])
        focus = o + d * focal_length
        o = o + offset
        d = focus - o
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d
