"""Asset pipeline tests: OBJ/PLY loaders, cache invalidation, file registry."""

import os
import time

import numpy as np

from d3d12renderer_jax.assets.cache import (
    FileRegistry, load_image_cached, load_with_cache,
)
from d3d12renderer_jax.assets.loaders import (
    generate_normals, generate_tangents, load_model, load_obj, load_ply,
    weld_mesh,
)

OBJ = """
mtllib test.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
"""

MTL = """
newmtl red
Kd 0.9 0.1 0.1
Ns 250
"""

PLY_ASCII = """ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
element face 2
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
1 1 0
0 1 0
3 0 1 2
3 0 2 3
"""


def test_obj_loader_with_mtl(tmp_path):
    (tmp_path / "quad.obj").write_text(OBJ)
    (tmp_path / "test.mtl").write_text(MTL)
    asset = load_obj(str(tmp_path / "quad.obj"))
    assert len(asset.meshes) == 1
    mesh = asset.meshes[0]
    assert len(mesh.indices) == 2  # quad fan-triangulated
    assert mesh.positions.shape == (4, 3)
    mat = asset.materials[0]
    assert abs(mat.albedo[0] - 0.9) < 1e-6
    assert mat.roughness < 0.8  # shininess mapped


def test_ply_ascii_loader(tmp_path):
    (tmp_path / "quad.ply").write_text(PLY_ASCII)
    asset = load_ply(str(tmp_path / "quad.ply"))
    mesh = asset.meshes[0]
    assert mesh.positions.shape == (4, 3)
    assert len(mesh.indices) == 2
    # Normals generated for normal-less file.
    np.testing.assert_allclose(
        np.abs(mesh.normals[:, 2]), 1.0, atol=1e-5)


def test_load_model_dispatch(tmp_path):
    (tmp_path / "m.ply").write_text(PLY_ASCII)
    asset = load_model(str(tmp_path / "m.ply"))
    assert len(asset.meshes) == 1


def test_mesh_postprocessing(tmp_path):
    (tmp_path / "quad.obj").write_text(OBJ)
    (tmp_path / "test.mtl").write_text(MTL)
    mesh = load_obj(str(tmp_path / "quad.obj")).meshes[0]
    tangents = generate_tangents(mesh)
    np.testing.assert_allclose(np.linalg.norm(tangents, axis=-1), 1.0, atol=1e-4)
    # Welding removes duplicates.
    dup = mesh
    import copy
    from d3d12renderer_jax.render.mesh import MeshData, merge
    two = merge([mesh, mesh])
    welded = weld_mesh(two)
    assert len(welded.positions) == 4


def test_cache_hit_and_invalidation(tmp_path):
    src = tmp_path / "data.txt"
    src.write_text("hello")
    calls = []

    def loader(p):
        calls.append(p)
        return {"content": open(p).read()}

    r1, cached1 = load_with_cache(str(src), loader)
    r2, cached2 = load_with_cache(str(src), loader)
    assert not cached1 and cached2
    assert len(calls) == 1
    assert r2["content"] == "hello"

    # Touch the source -> invalidated.
    time.sleep(0.01)
    src.write_text("world")
    r3, cached3 = load_with_cache(str(src), loader)
    assert not cached3 and r3["content"] == "world"
    assert len(calls) == 2


def test_image_cache(tmp_path):
    from PIL import Image

    img = Image.fromarray((np.random.default_rng(0).uniform(
        0, 255, (16, 16, 3))).astype(np.uint8))
    p = str(tmp_path / "tex.png")
    img.save(p)
    mips, cached = load_image_cached(p, generate_mips=True)
    assert not cached
    assert mips[0].shape == (16, 16, 3)
    assert mips[-1].shape[0] == 1
    mips2, cached2 = load_image_cached(p, generate_mips=True)
    assert cached2


def test_file_registry_handles_and_watch(tmp_path):
    (tmp_path / "a.obj").write_text("v 0 0 0")
    reg = FileRegistry(str(tmp_path), seed=42)
    h = reg.handle_for(str(tmp_path / "a.obj"))
    assert reg.path_for(h).endswith("a.obj")
    # Stable across save/load.
    reg.save()
    reg2 = FileRegistry(str(tmp_path), seed=1)
    assert reg2.handle_for(str(tmp_path / "a.obj")) == h

    events = []
    reg.on_change(lambda kind, rel: events.append((kind, rel)))
    (tmp_path / "b.obj").write_text("v 1 1 1")
    reg.scan()
    assert ("added", "b.obj") in events
    time.sleep(0.01)
    (tmp_path / "b.obj").write_text("v 2 2 2")
    reg.scan()
    assert ("modified", "b.obj") in events
    os.remove(tmp_path / "b.obj")
    reg.scan()
    assert ("deleted", "b.obj") in events


def test_native_mesh_ops():
    """Native C++ mesh ops compile and agree with the NumPy fallbacks."""
    import numpy as np

    from d3d12renderer_jax.assets import native

    assert native.native_available(), "g++ build of native/mesh_ops.cpp failed"

    rng = np.random.default_rng(0)
    pos = rng.normal(size=(500, 3)).astype(np.float32)
    pos_dup = np.concatenate([pos, pos[:100] + 1e-7])
    unique, remap = native.weld_remap(pos_dup, tolerance=1e-4)
    assert unique == 500
    assert (remap[:100] == remap[500:]).all()

    idx = rng.integers(0, 500, size=(300, 3)).astype(np.int32)
    n_native = native.compute_normals(pos, idx)
    # Force the fallback for comparison.
    native._lib, native._tried = None, True
    try:
        n_py = native.compute_normals(pos, idx)
    finally:
        native._tried = False
    np.testing.assert_allclose(n_native, n_py, atol=1e-5)

    text = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n"
    p, t = native.parse_obj_geometry(text)
    assert p.shape == (4, 3) and t.shape == (2, 3)
    assert t[0].tolist() == [0, 1, 2] and t[1].tolist() == [0, 2, 3]


def test_native_obj_speed_sanity():
    """The native parser handles a larger synthetic OBJ correctly."""
    import numpy as np

    from d3d12renderer_jax.assets import native

    rng = np.random.default_rng(1)
    n = 5000
    verts = rng.normal(size=(n, 3))
    lines = [f"v {x:.5f} {y:.5f} {z:.5f}" for x, y, z in verts]
    faces = rng.integers(1, n + 1, size=(8000, 3))
    lines += [f"f {a} {b} {c}" for a, b, c in faces]
    text = "\n".join(lines) + "\n"
    p, t = native.parse_obj_geometry(text)
    assert p.shape == (n, 3) and t.shape == (8000, 3)
    np.testing.assert_allclose(p, verts.astype(np.float32), atol=1e-4)
    np.testing.assert_array_equal(t, faces - 1)


def test_fbx_binary_roundtrip(tmp_path):
    """Write a minimal binary FBX (zlib-compressed arrays) and load it back —
    the reference's debug-dump round-trip pattern (fbx.cpp:18-20)."""
    from d3d12renderer_jax.assets.fbx import load_fbx, parse_fbx, write_fbx_geometry
    from d3d12renderer_jax.render.mesh import ico_sphere

    src = ico_sphere(1.0, 1)
    p = str(tmp_path / "mesh.fbx")
    write_fbx_geometry(p, src.positions, src.indices, normals=src.normals,
                       uvs=src.uvs)

    root, version = parse_fbx(open(p, "rb").read())
    assert version == 7400
    assert root.find("Objects").find("Geometry") is not None

    asset = load_fbx(p)
    assert len(asset.meshes) == 1
    mesh = asset.meshes[0]
    assert len(mesh.indices) == len(src.indices)
    # Per-corner expansion: positions match triangle-by-triangle.
    expect = src.positions[src.indices.reshape(-1)]
    np.testing.assert_allclose(mesh.positions, expect, atol=1e-5)
    nrm = src.normals[src.indices.reshape(-1)]
    np.testing.assert_allclose(mesh.normals, nrm, atol=1e-5)


def test_fbx_quad_triangulation(tmp_path):
    """Polygon (quad) faces triangulate like the reference's fan split."""
    import struct as pystruct

    from d3d12renderer_jax.assets.fbx import (
        FBXNode, MAGIC, _write_node, load_fbx,
    )

    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float64)
    poly = np.array([0, 1, 2, ~3], np.int32)  # one quad
    geom = FBXNode("Geometry", [1, "Geometry::q", "Mesh"])
    geom.children.append(FBXNode("Vertices", [verts.reshape(-1)]))
    geom.children.append(FBXNode("PolygonVertexIndex", [poly]))
    objects = FBXNode("Objects")
    objects.children.append(geom)
    blob = MAGIC + pystruct.pack("<I", 7400)
    blob += _write_node(objects, len(blob))
    blob += b"\x00" * 13
    p = str(tmp_path / "quad.fbx")
    open(p, "wb").write(blob)

    asset = load_fbx(p)
    mesh = asset.meshes[0]
    assert len(mesh.indices) == 2  # quad -> 2 triangles
    # Normals were generated (no layer present).
    np.testing.assert_allclose(np.abs(mesh.normals[:, 2]), 1.0, atol=1e-5)


def test_bc1_texture_codec_roundtrip():
    """BC1 cache codec (reference .cache.dds, src/asset/image.cpp:76-96):
    solid blocks are near-exact, natural gradients stay above 30 dB PSNR,
    and the packed payload is ~24x smaller than the float32 mips."""
    import pickle

    from d3d12renderer_jax.assets import texcompress as tc

    # Solid color: endpoints collapse to the color -> error is pure 565
    # quantization (< 1/62 per channel in sRGB).
    solid = np.full((16, 16, 3), 0.3, np.float32)
    dec = tc.bc1_decode(tc.bc1_encode(solid))
    assert np.abs(tc._to_srgb(dec) - tc._to_srgb(solid)).max() < 1 / 31

    # Natural content: smooth gradient + low noise, 8-bit quantized like a
    # real texture.
    rng = np.random.default_rng(0)
    x, y = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 64))
    img = np.stack([x, y, 0.5 + 0.2 * np.sin(6 * x)], -1)
    img = np.clip(img + rng.normal(0, 0.01, img.shape), 0, 1)
    img8 = np.round(tc._to_srgb(img.astype(np.float32)) * 255) / 255
    lin = tc._from_srgb(img8).astype(np.float32)
    dec = tc.bc1_decode(tc.bc1_encode(lin))
    mse = float(np.mean((tc._to_srgb(dec) - tc._to_srgb(lin)) ** 2))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    assert psnr > 30.0, f"BC1 PSNR {psnr:.1f} dB"

    payload = tc.pack_mips([lin], hdr=False)
    assert payload["mips"][0]["format"] == "bc1"
    packed = len(pickle.dumps(payload))
    raw = lin.nbytes
    assert packed * 12 < raw, f"only {raw / packed:.1f}x smaller"

    # 16-bit-ish content (not 8-bit representable) must take the f16 path.
    hi = (lin + rng.uniform(0, 1 / 1024, lin.shape)).astype(np.float32)
    assert tc.pack_mips([hi], hdr=False)["mips"][0]["format"] == "f16"
