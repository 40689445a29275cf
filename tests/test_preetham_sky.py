"""Preetham analytic daylight sky (reference: the procedural sky path,
shaders/sky/sky_procedural_ps.hlsl; model: Preetham/Shirley/Smits 1999)."""

import numpy as np
import jax.numpy as jnp

from d3d12renderer_jax.render.pathtracer import (
    default_sky, preetham_sky, sky_radiance,
)


def _dirs(sun):
    sd = np.asarray(sun, np.float64)
    sd /= np.linalg.norm(sd)
    hs = np.array([sd[0], 0.02, sd[2]])
    hs /= np.linalg.norm(hs)
    return sd, jnp.asarray(
        np.stack([[0.0, 1.0, 0.0], hs, [-hs[0], 0.02, -hs[2]],
                  [0.0, -1.0, 0.0]]), jnp.float32)


def test_preetham_shape_properties():
    sky = preetham_sky((0.3, 0.5, 0.2), turbidity=3.0)
    _, ds = _dirs((0.3, 0.5, 0.2))
    r = np.asarray(sky_radiance(sky, ds))
    assert np.isfinite(r).all() and (r >= 0).all()
    zenith, circum, anti, below = r
    # Circumsolar brightening: the horizon toward the sun outshines the
    # antisolar horizon; both are haze-desaturated vs the blue zenith.
    assert circum.sum() > anti.sum() * 1.3
    assert zenith[2] / zenith.sum() > circum[2] / circum.sum()
    # Below the horizon the ground color takes over.
    assert np.allclose(below, np.asarray(sky.ground), atol=1e-5)


def test_preetham_turbidity_desaturates():
    """Higher turbidity (hazier) pushes the zenith away from saturated
    blue toward white."""
    _, ds = _dirs((0.3, 0.5, 0.2))
    frac = []
    for t in (2.0, 8.0):
        sky = preetham_sky((0.3, 0.5, 0.2), turbidity=t)
        z = np.asarray(sky_radiance(sky, ds))[0]
        frac.append(z[2] / z.sum())
    assert frac[1] < frac[0]


def test_preetham_sun_disc_rides_on_top():
    sky = preetham_sky((0.0, 0.7, 0.7), turbidity=3.0)
    sd = np.asarray(sky.sun_direction)
    r_sun = np.asarray(sky_radiance(sky, jnp.asarray(sd[None], jnp.float32)))
    assert (r_sun >= np.asarray(sky.sun_radiance)).all()


def test_gradient_sky_unchanged():
    """turbidity=None keeps the simple gradient (exact regression pin)."""
    sky = default_sky()
    d = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    r = np.asarray(sky_radiance(sky, d))[0]
    assert np.allclose(r, np.asarray(sky.zenith), atol=1e-5)
