"""Terrain LOD chunking with hole-free seams + tri-material splatting
(VERDICT r1 item 9; reference: shaders/terrain/terrain_vs.hlsl LOD seam
collapse, src/terrain/terrain.h:31 splatting).
"""

import numpy as np
import jax.numpy as jnp

from d3d12renderer_jax.terrain.heightmap import (
    generate_heightmap, shade_splat, splat_weights, terrain_lod_chunks,
)


def _chunks():
    h = np.asarray(generate_heightmap(resolution=33, world_size=32.0,
                                      amplitude=6.0, seed=3))
    # Camera at one corner: nearest chunk gets LOD 0, the far diagonal ones
    # get coarser levels.
    return h, terrain_lod_chunks(
        h, origin=(0.0, 0.0, 0.0), cell_size=1.0, chunk_cells=16,
        camera_pos=(0.0, 0.0, 0.0), lod_distances=(20.0, 34.0, 60.0))


def test_lod_levels_increase_with_distance():
    _, chunks = _chunks()
    lods = {cc: lod for _, lod, cc in chunks}
    assert lods[(0, 0)] < lods[(1, 1)], lods
    # Strides: vertex counts shrink at coarser LOD.
    counts = {cc: mesh.positions.shape[0] for mesh, _, cc in chunks}
    assert counts[(1, 1)] < counts[(0, 0)]


def test_lod_seams_are_watertight():
    _, chunks = _chunks()
    by_cc = {cc: (mesh, lod) for mesh, lod, cc in chunks}
    checked = 0
    for (ci, cj), (mesh, lod) in by_cc.items():
        for (nci, ncj), axis in (((ci + 1, cj), 0), ((ci, cj + 1), 2)):
            if (nci, ncj) not in by_cc:
                continue
            nmesh, nlod = by_cc[(nci, ncj)]
            # Shared boundary coordinate.
            bound = (nci * 16.0) if axis == 0 else (ncj * 16.0)
            t_axis = 2 if axis == 0 else 0     # coordinate along the edge
            pa = mesh.positions
            pb = nmesh.positions
            ea = pa[np.abs(pa[:, axis] - bound) < 1e-4]
            eb = pb[np.abs(pb[:, axis] - bound) < 1e-4]
            assert len(ea) and len(eb)
            ea = ea[np.argsort(ea[:, t_axis])]
            eb = eb[np.argsort(eb[:, t_axis])]
            fine, coarse = (ea, eb) if len(ea) >= len(eb) else (eb, ea)
            # Every fine edge vertex must lie ON the coarse edge polyline.
            for v in fine:
                t = v[t_axis]
                k = np.searchsorted(coarse[:, t_axis], t) - 1
                k = np.clip(k, 0, len(coarse) - 2)
                a, b = coarse[k], coarse[k + 1]
                span = b[t_axis] - a[t_axis]
                f = 0.0 if span == 0 else (t - a[t_axis]) / span
                y = a[1] * (1 - f) + b[1] * f
                assert abs(v[1] - y) < 1e-4, (
                    f"crack at {(ci, cj)}->{(nci, ncj)}: {v[1]} vs {y}")
            checked += 1
    assert checked >= 2


def test_splat_weights_slope_and_height():
    # A ramp rising along i: flat start (grass), steep middle (rock)...
    r = 33
    h = np.zeros((r, r), np.float32)
    h[16:, :] = np.linspace(0, 12, 17)[:, None]   # steep section
    h[28:, :] = 12.0                              # high plateau (snow zone)
    w = np.asarray(splat_weights(jnp.asarray(h), 1.0))
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-5)
    assert w[4, 16, 0] > 0.9, "flat low ground should be grass"
    assert w[20, 16, 1] > 0.5, "steep slope should be rock"
    assert w[31, 16, 2] > 0.5, "high flat plateau should be snow"

    colors = shade_splat(jnp.asarray(w), [[0.2, 0.5, 0.1],
                                          [0.4, 0.38, 0.35],
                                          [0.9, 0.9, 0.95]])
    c = np.asarray(colors)
    assert c.shape == (r, r, 3)
    # Grass region greener than the snow region; snow brighter.
    assert c[4, 16, 1] > c[4, 16, 0]
    assert c[31, 16].mean() > c[4, 16].mean()
