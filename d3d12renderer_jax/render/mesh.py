"""Procedural mesh builder + triangle-mesh SoA for the renderer.

Host-side equivalent of the reference mesh builder's primitive set
(reference: src/geometry/mesh_builder.h:169-181 pushQuad/Box/Sphere/IcoSphere/
Capsule/Cylinder/HollowCylinder/Arrow/Torus/Mace).  Produces numpy arrays that
upload as device triangle soup for BVH tracing or rasterization.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class MeshData:
    """Indexed triangle mesh with per-vertex attributes."""

    positions: np.ndarray          # (V, 3) float32
    normals: np.ndarray            # (V, 3)
    uvs: np.ndarray                # (V, 2)
    indices: np.ndarray            # (T, 3) int32

    def transformed(self, translate=(0, 0, 0), rotate=None, scale=1.0):
        p = self.positions * np.asarray(scale, np.float32)
        n = self.normals
        if rotate is not None:
            r = _quat_mat(np.asarray(rotate, np.float64))
            p = p @ r.T
            n = n @ r.T
        p = p + np.asarray(translate, np.float32)
        return MeshData(p.astype(np.float32), n.astype(np.float32),
                        self.uvs, self.indices)


def _quat_mat(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def merge(meshes: List[MeshData]) -> MeshData:
    offs = 0
    ps, ns, uvs, idx = [], [], [], []
    for mesh in meshes:
        ps.append(mesh.positions)
        ns.append(mesh.normals)
        uvs.append(mesh.uvs)
        idx.append(mesh.indices + offs)
        offs += len(mesh.positions)
    return MeshData(
        np.concatenate(ps), np.concatenate(ns), np.concatenate(uvs),
        np.concatenate(idx),
    )


def quad(half=1.0) -> MeshData:
    p = np.array([[-half, 0, -half], [half, 0, -half],
                  [half, 0, half], [-half, 0, half]], np.float32)
    n = np.tile([0, 1, 0], (4, 1)).astype(np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    i = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    return MeshData(p, n, uv, i)


def box(half_extents=(1.0, 1.0, 1.0)) -> MeshData:
    hx, hy, hz = half_extents
    faces = []
    for axis, sign in [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]:
        n = np.zeros(3)
        n[axis] = sign
        u = np.zeros(3)
        u[(axis + 1) % 3] = 1.0
        v = np.cross(n, u)
        c = n * [hx, hy, hz][axis]
        us = u * [hx, hy, hz][(axis + 1) % 3]
        vs = v * np.abs(v @ [hx, hy, hz])
        p = np.stack([c - us - vs, c + us - vs, c + us + vs, c - us + vs])
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        if sign > 0:
            idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        else:
            idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
        faces.append(MeshData(
            p.astype(np.float32), np.tile(n, (4, 1)).astype(np.float32), uv, idx
        ))
    return merge(faces)


def uv_sphere(radius=1.0, rings=16, slices=32) -> MeshData:
    ps, ns, uvs = [], [], []
    for r in range(rings + 1):
        phi = math.pi * r / rings
        for s in range(slices + 1):
            theta = 2 * math.pi * s / slices
            n = np.array([
                math.sin(phi) * math.cos(theta),
                math.cos(phi),
                math.sin(phi) * math.sin(theta),
            ])
            ps.append(n * radius)
            ns.append(n)
            uvs.append([s / slices, r / rings])
    idx = []
    stride = slices + 1
    for r in range(rings):
        for s in range(slices):
            a = r * stride + s
            b = a + stride
            idx.append([a, b, a + 1])
            idx.append([a + 1, b, b + 1])
    return MeshData(np.array(ps, np.float32), np.array(ns, np.float32),
                    np.array(uvs, np.float32), np.array(idx, np.int32))


def ico_sphere(radius=1.0, subdivisions=2) -> MeshData:
    t = (1 + math.sqrt(5)) / 2
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ]
    verts = list(verts)
    for _ in range(subdivisions):
        cache = {}
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                m /= np.linalg.norm(m)
                verts.append(m)
                cache[key] = len(verts) - 1
            return cache[key]

        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = new_faces

    p = np.array(verts, np.float32)
    uv = np.stack([
        0.5 + np.arctan2(p[:, 2], p[:, 0]) / (2 * math.pi),
        0.5 - np.arcsin(np.clip(p[:, 1], -1, 1)) / math.pi,
    ], axis=-1).astype(np.float32)
    return MeshData(p * radius, p.copy(), uv, np.array(faces, np.int32))


def cylinder(radius=1.0, half_height=1.0, slices=32, caps=True) -> MeshData:
    ps, ns, uvs, idx = [], [], [], []
    for s in range(slices + 1):
        theta = 2 * math.pi * s / slices
        n = np.array([math.cos(theta), 0.0, math.sin(theta)])
        for y, v in [(half_height, 0.0), (-half_height, 1.0)]:
            ps.append(n * radius + [0, y, 0])
            ns.append(n)
            uvs.append([s / slices, v])
    for s in range(slices):
        a = s * 2
        idx += [[a, a + 2, a + 1], [a + 1, a + 2, a + 3]]
    meshes = [MeshData(np.array(ps, np.float32), np.array(ns, np.float32),
                       np.array(uvs, np.float32), np.array(idx, np.int32))]
    if caps:
        for sign in (1, -1):
            cp, cn, cuv, cidx = [], [], [], []
            cp.append([0, sign * half_height, 0])
            cn.append([0, sign, 0])
            cuv.append([0.5, 0.5])
            for s in range(slices + 1):
                theta = 2 * math.pi * s / slices
                cp.append([radius * math.cos(theta), sign * half_height,
                           radius * math.sin(theta)])
                cn.append([0, sign, 0])
                cuv.append([0.5 + 0.5 * math.cos(theta), 0.5 + 0.5 * math.sin(theta)])
            for s in range(slices):
                if sign > 0:
                    cidx.append([0, s + 2, s + 1])
                else:
                    cidx.append([0, s + 1, s + 2])
            meshes.append(MeshData(np.array(cp, np.float32), np.array(cn, np.float32),
                                   np.array(cuv, np.float32), np.array(cidx, np.int32)))
    return merge(meshes)


def capsule(radius=1.0, half_length=1.0, rings=8, slices=24) -> MeshData:
    """Capsule along Y: cylinder + hemisphere ends."""
    meshes = [cylinder(radius, half_length, slices, caps=False)]
    for sign in (1, -1):
        ps, ns, uvs, idx = [], [], [], []
        for r in range(rings + 1):
            phi = 0.5 * math.pi * r / rings
            for s in range(slices + 1):
                theta = 2 * math.pi * s / slices
                n = np.array([
                    math.sin(phi) * math.cos(theta),
                    sign * math.cos(phi),
                    math.sin(phi) * math.sin(theta),
                ])
                ps.append(n * radius + [0, sign * half_length, 0])
                ns.append(n)
                uvs.append([s / slices, r / rings])
        stride = slices + 1
        for r in range(rings):
            for s in range(slices):
                a = r * stride + s
                b = a + stride
                if sign > 0:
                    idx += [[a, a + 1, b], [a + 1, b + 1, b]]
                else:
                    idx += [[a, b, a + 1], [a + 1, b, b + 1]]
        meshes.append(MeshData(np.array(ps, np.float32), np.array(ns, np.float32),
                               np.array(uvs, np.float32), np.array(idx, np.int32)))
    return merge(meshes)


def torus(major=1.0, minor=0.25, major_slices=32, minor_slices=16) -> MeshData:
    ps, ns, uvs, idx = [], [], [], []
    for i in range(major_slices + 1):
        a = 2 * math.pi * i / major_slices
        center = np.array([math.cos(a), 0.0, math.sin(a)]) * major
        for j in range(minor_slices + 1):
            b = 2 * math.pi * j / minor_slices
            n = np.array([
                math.cos(a) * math.cos(b), math.sin(b), math.sin(a) * math.cos(b),
            ])
            ps.append(center + n * minor)
            ns.append(n)
            uvs.append([i / major_slices, j / minor_slices])
    stride = minor_slices + 1
    for i in range(major_slices):
        for j in range(minor_slices):
            a = i * stride + j
            b = a + stride
            idx += [[a, b, a + 1], [a + 1, b, b + 1]]
    return MeshData(np.array(ps, np.float32), np.array(ns, np.float32),
                    np.array(uvs, np.float32), np.array(idx, np.int32))


def arrow(shaft_radius=0.05, head_radius=0.12, shaft_len=0.7, head_len=0.3,
          slices=16) -> MeshData:
    """Arrow along +Y (reference: mesh_builder.h pushArrow)."""
    shaft = cylinder(shaft_radius, shaft_len / 2, slices).transformed(
        translate=(0, shaft_len / 2, 0))
    # Cone head.
    ps, ns, uvs, idx = [], [], [], []
    tip = np.array([0, shaft_len + head_len, 0])
    for s in range(slices + 1):
        theta = 2 * math.pi * s / slices
        d = np.array([math.cos(theta), 0, math.sin(theta)])
        base = d * head_radius + [0, shaft_len, 0]
        slope = np.array([d[0], head_radius / max(head_len, 1e-6), d[2]])
        slope /= np.linalg.norm(slope)
        ps += [base, tip]
        ns += [slope, slope]
        uvs += [[s / slices, 1], [s / slices, 0]]
    for s in range(slices):
        a = s * 2
        idx.append([a, a + 2, a + 1])
    head = MeshData(np.array(ps, np.float32), np.array(ns, np.float32),
                    np.array(uvs, np.float32), np.array(idx, np.int32))
    return merge([shaft, head])


def mace(shaft_radius=0.05, head_radius=0.25, shaft_len=0.8, slices=16) -> MeshData:
    """Shaft + spiky ball head (reference: mesh_builder.h pushMace)."""
    shaft = cylinder(shaft_radius, shaft_len / 2, slices).transformed(
        translate=(0, shaft_len / 2, 0))
    head = ico_sphere(head_radius, 1).transformed(translate=(0, shaft_len, 0))
    return merge([shaft, head])


def hollow_cylinder(radius=1.0, inner_radius=0.5, half_height=0.5,
                    slices=32) -> MeshData:
    outer = cylinder(radius, half_height, slices, caps=False)
    inner = cylinder(inner_radius, half_height, slices, caps=False)
    inner.indices[:] = inner.indices[:, ::-1]
    inner.normals[:] = -inner.normals
    rings = []
    for sign in (1, -1):
        ps, ns, uvs, idx = [], [], [], []
        for s in range(slices + 1):
            theta = 2 * math.pi * s / slices
            d = np.array([math.cos(theta), 0, math.sin(theta)])
            ps += [d * inner_radius + [0, sign * half_height, 0],
                   d * radius + [0, sign * half_height, 0]]
            ns += [[0, sign, 0], [0, sign, 0]]
            uvs += [[s / slices, 0], [s / slices, 1]]
        for s in range(slices):
            a = s * 2
            if sign > 0:
                idx += [[a, a + 2, a + 1], [a + 1, a + 2, a + 3]]
            else:
                idx += [[a, a + 1, a + 2], [a + 1, a + 3, a + 2]]
        rings.append(MeshData(np.array(ps, np.float32), np.array(ns, np.float32),
                              np.array(uvs, np.float32), np.array(idx, np.int32)))
    return merge([outer, inner] + rings)


def sphere_grid_scene(rings, slices, n=8, radius=0.45, spacing=1.2,
                      ground_half=8.0):
    """The shared ray-benchmark scene: an n x n grid of UV spheres over a
    ground quad; bench.py's ray leg traces it (rings/slices set the
    triangle count: (16, 26) ~ 53k tris, (44, 88) ~ 495k)."""
    meshes = []
    for ix in range(n):
        for iz in range(n):
            s = uv_sphere(radius, rings, slices).transformed(
                translate=(ix * spacing - n * spacing / 2, 0.5,
                           iz * spacing - n * spacing / 2))
            meshes.append((s, (ix + iz) % 4))
    meshes.append((quad(ground_half), 0))
    return meshes


def atrium_scene(detail: float = 1.0, ground_half: float = 14.0):
    """Sponza-class architectural benchmark scene: a two-story colonnaded
    courtyard (~260k triangles at detail=1.0) standing in for the
    reference's Sponza content (reference: src/application.cpp:106 loads
    Sponza ~260k tris as the default editor scene; the asset itself cannot
    ship here, so the geometry CLASS is reproduced procedurally: long
    occluded interiors, repeated curved trim, thin balusters — the shapes
    that make ray/raster numbers honest in ways sphere grids are not).

    Returns a list of (MeshData, material_id) with 6 materials:
    0 floor, 1 column stone, 2 trim/capitals, 3 balustrade, 4 fountain
    metal, 5 cloth banners.  `detail` scales tessellation (0.2 ~ 12k tris
    for CPU golden tests)."""
    def d(n, lo=3):
        return max(int(round(n * detail)), lo)

    meshes: List[Tuple[MeshData, int]] = []
    cw, cd = 10.0, 7.0          # court half-width / half-depth
    story = [0.0, 3.2]          # story base heights

    meshes.append((quad(ground_half), 0))
    # Perimeter walls (boxes; tops open to the sky like Sponza's court).
    for sx in (-1.0, 1.0):
        meshes.append((box((0.4, 3.4, cd + 1.6)).transformed(
            translate=(sx * (cw + 1.2), 3.4, 0.0)), 1))
    for sz in (-1.0, 1.0):
        meshes.append((box((cw + 1.6, 3.4, 0.4)).transformed(
            translate=(0.0, 3.4, sz * (cd + 1.2))), 1))

    # Colonnades: two rows x two stories along +-z edges of the court.
    ncol = 8
    for level, base in enumerate(story):
        r = 0.28 if level == 0 else 0.22
        h = 1.1 if level == 0 else 0.9
        for i in range(ncol):
            x = (i + 0.5) / ncol * 2 * cw - cw
            for sz in (-1.0, 1.0):
                z = sz * (cd - 0.6)
                shaft = cylinder(r, h, slices=d(40)).transformed(
                    translate=(x, base + h + 0.3, z))
                meshes.append((shaft, 1))
                for (ty, mat) in ((base + 0.22, 2),
                                  (base + 2 * h + 0.38, 2)):
                    meshes.append((torus(
                        r + 0.1, 0.09, major_slices=d(36),
                        minor_slices=d(14)).transformed(
                            translate=(x, ty, z)), mat))
                meshes.append((box((r + 0.22, 0.08, r + 0.22)).transformed(
                    translate=(x, base + 2 * h + 0.52, z)), 2))
        # Architrave beams the columns carry.
        for sz in (-1.0, 1.0):
            meshes.append((box((cw, 0.16, 0.45)).transformed(
                translate=(0.0, base + 2 * h + 0.76, sz * (cd - 0.6))), 2))

    # Second-floor balustrade: thin balusters + handrail (the classic
    # many-thin-occluders raytracing stressor).
    nbal = int(56 * max(detail, 0.25))
    for sz in (-1.0, 1.0):
        z = sz * (cd - 1.4)
        meshes.append((box((cw - 0.4, 0.05, 0.09)).transformed(
            translate=(0.0, story[1] + 0.95, z)), 3))
        for i in range(nbal):
            x = (i + 0.5) / nbal * 2 * (cw - 0.5) - (cw - 0.5)
            meshes.append((capsule(0.045, 0.34, rings=d(6, 2),
                                   slices=d(14, 6)).transformed(
                translate=(x, story[1] + 0.55, z)), 3))

    # Arch rings over the lower colonnade bays (lower half hides in the
    # architrave, reading as arches from the court).
    for sz in (-1.0, 1.0):
        for i in range(ncol - 1):
            x = (i + 1.0) / ncol * 2 * cw - cw
            arch = hollow_cylinder(
                1.05, 0.82, 0.18, slices=d(40)).transformed(
                    rotate=(np.sin(np.pi / 4), 0, 0, np.cos(np.pi / 4)),
                    translate=(x, story[1] - 0.3, sz * (cd - 0.6)))
            meshes.append((arch, 2))

    # Central fountain: basin ring, pedestal, reflective orb.
    meshes.append((hollow_cylinder(2.4, 2.0, 0.35, slices=d(64)).transformed(
        translate=(0, 0.35, 0)), 1))
    meshes.append((cylinder(0.35, 0.6, slices=d(28)).transformed(
        translate=(0, 0.6, 0)), 2))
    meshes.append((uv_sphere(0.55, d(28), d(48)).transformed(
        translate=(0, 1.75, 0)), 4))
    meshes.append((torus(1.0, 0.12, major_slices=d(48),
                         minor_slices=d(12)).transformed(
        translate=(0, 1.2, 0)), 4))

    # Hanging cloth banners (large tilted quads, like Sponza's drapes).
    for i, x in enumerate((-6.0, -2.0, 2.0, 6.0)):
        banner = quad(1.0).transformed(
            rotate=(np.sin(np.pi / 4 + 0.06 * i), 0, 0,
                    np.cos(np.pi / 4 + 0.06 * i)),
            scale=(0.9, 1.0, 1.6),
            translate=(x, 4.6, 0.2 * (i % 2) - 2.0))
        meshes.append((banner, 5))

    # Coffered ceiling slabs under the upper walkway.
    ncof = int(12 * max(detail, 0.3))
    for sz in (-1.0, 1.0):
        for i in range(ncof):
            x = (i + 0.5) / ncof * 2 * (cw - 0.6) - (cw - 0.6)
            meshes.append((box((0.55, 0.06, 0.5)).transformed(
                translate=(x, story[1] - 0.12, sz * (cd - 0.6))), 2))
    return meshes
