"""HDR/EXR/16-bit image IO + float derived cache + IBL ingestion
(VERDICT r2 missing item 2; reference: src/asset/image.cpp:76-96)."""

import os

import numpy as np
import pytest

from d3d12renderer_jax.assets.image_io import (
    load_exr, load_hdr, load_png16, save_exr, save_hdr, save_png16,
)


@pytest.fixture
def radiance():
    rng = np.random.default_rng(3)
    img = rng.gamma(1.5, 0.4, (33, 47, 3)).astype(np.float32)
    img[4:8, 10:14] = 1500.0          # sun-level values
    img[20, 5] = 0.0
    return img


def test_hdr_roundtrip(radiance, tmp_path):
    p = str(tmp_path / "r.hdr")
    save_hdr(p, radiance)
    back = load_hdr(p)
    assert back.shape == radiance.shape
    # RGBE shares one exponent across channels: error is bounded by
    # ~max_channel/256 per pixel, not by per-channel relative precision.
    bound = radiance.max(-1, keepdims=True) / 256.0 + 1e-5
    assert (np.abs(back - radiance) <= bound).all()


def test_hdr_rle_compresses_flat_regions(tmp_path):
    img = np.full((32, 64, 3), 0.25, np.float32)
    p = str(tmp_path / "flat.hdr")
    save_hdr(p, img)
    assert os.path.getsize(p) < 32 * 64 * 4 / 4, "RLE should beat flat RGBE"
    np.testing.assert_allclose(load_hdr(p), img, rtol=0.01)


def test_exr_roundtrip_float(radiance, tmp_path):
    p = str(tmp_path / "r.exr")
    save_exr(p, radiance)
    back = load_exr(p)
    np.testing.assert_array_equal(back, radiance)   # float32 is lossless


def test_exr_roundtrip_half(radiance, tmp_path):
    p16 = str(tmp_path / "r16.exr")
    p32 = str(tmp_path / "r32.exr")
    save_exr(p16, radiance, half=True)
    save_exr(p32, radiance)
    back = load_exr(p16)
    np.testing.assert_allclose(back, radiance, rtol=1e-3, atol=1e-6)
    assert os.path.getsize(p16) < 0.7 * os.path.getsize(p32)


def test_png16_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    hmap = rng.uniform(0, 1, (24, 31)).astype(np.float32)
    p = str(tmp_path / "h.png")
    save_png16(p, hmap)
    back = load_png16(p)
    np.testing.assert_allclose(back[..., 0], hmap, atol=1.1 / 65535)


def test_float_radiance_through_cache(radiance, tmp_path):
    """A real HDR file loads through the derived-data cache preserving float
    radiance (no 8-bit clip), and re-load hits the cache."""
    from d3d12renderer_jax.assets.cache import load_image_cached

    p = str(tmp_path / "env.hdr")
    save_hdr(p, radiance)
    mips, cached = load_image_cached(p, generate_mips=True)
    assert not cached
    assert mips[0].max() > 1000.0, "HDR values must survive the cache"
    bound = radiance.max(-1, keepdims=True) / 256.0 + 1e-5
    assert (np.abs(mips[0] - radiance) <= bound).all()
    assert len(mips) > 3 and mips[-1].shape[0] == 1
    mips2, cached2 = load_image_cached(p, generate_mips=True)
    assert cached2
    np.testing.assert_array_equal(mips2[0], mips[0])


def test_exr_through_cache_linear(tmp_path):
    """EXR decode must NOT apply sRGB decode (it is already linear)."""
    from d3d12renderer_jax.assets.cache import load_image

    img = np.full((8, 8, 3), 0.5, np.float32)
    p = str(tmp_path / "l.exr")
    save_exr(p, img)
    arr = load_image(p)[0]
    np.testing.assert_allclose(arr, 0.5, atol=1e-6)


def test_demo_envmap_hdr_into_ibl(tmp_path):
    """The committed-style demo envmap flows through cache -> cubemap ->
    SH irradiance: the sun must dominate the irradiance direction."""
    import jax.numpy as jnp

    from d3d12renderer_jax.assets.cache import load_image_cached
    from d3d12renderer_jax.assets.envmap import (
        DEFAULT_SUN, ensure_demo_envmap,
    )
    from d3d12renderer_jax.render.ibl import (
        equirect_to_cubemap, eval_irradiance_sh9, irradiance_sh9,
        sample_equirect,
    )

    p = ensure_demo_envmap(str(tmp_path / "studio.hdr"), height=64)
    mips, _ = load_image_cached(p)
    env = jnp.asarray(mips[0])
    assert float(env.max()) > 500.0

    cube = equirect_to_cubemap(env, 32)
    assert cube.shape == (6, 32, 32, 3)
    assert float(cube.max()) > 500.0     # sun disc lands on some face

    sh = irradiance_sh9(lambda d: sample_equirect(env, d), num_samples=8192)
    sun = np.asarray(DEFAULT_SUN) / np.linalg.norm(DEFAULT_SUN)
    irr_sun = np.asarray(eval_irradiance_sh9(sh, jnp.asarray(sun[None])))
    irr_away = np.asarray(eval_irradiance_sh9(sh, jnp.asarray(-sun[None])))
    assert irr_sun.mean() > 2.0 * irr_away.mean()
