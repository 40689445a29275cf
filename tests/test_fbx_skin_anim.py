"""FBX skins + animation clips + ASCII variant (VERDICT r1 item 7).

Round-trips a synthetic 2-bone skinned mesh with a rotation clip through the
binary writer -> importer -> skeleton/clip conversion -> FK -> LBS skinning,
checking analytically-known deformed positions (golden-test pattern from the
reference's debug dumps, src/asset/fbx.cpp:18-20).
"""

import numpy as np
import jax.numpy as jnp

from d3d12renderer_jax.assets.fbx import (
    load_fbx, parse_fbx_ascii, write_fbx_skinned,
)
from d3d12renderer_jax.animation.animation import (
    forward_kinematics, sample_clip, skinning_transforms,
)
from d3d12renderer_jax.animation.skinning import skin_vertices

CPS = np.array([
    [0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 2.0, 0.0], [1.0, 2.0, 0.0],
])
TRIS = np.array([[0, 1, 2], [1, 3, 2]], np.int32)

JOINTS = [
    ("root", -1, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
    ("bone", 0, (0.0, 1.0, 0.0), (0.0, 0.0, 0.0)),
]
CLUSTERS = [
    (0, [0, 1], [1.0, 1.0]),   # lower verts -> root
    (1, [2, 3], [1.0, 1.0]),   # upper verts -> bone
]
ROT_TRACKS = {1: ([0.0, 1.0], [[0.0, 0.0, 0.0], [0.0, 0.0, 90.0]])}


def _write(tmp_path):
    path = str(tmp_path / "arm.fbx")
    write_fbx_skinned(path, CPS, TRIS, JOINTS, CLUSTERS, ROT_TRACKS)
    return path


def test_fbx_skeleton_and_skin_import(tmp_path):
    asset = load_fbx(_write(tmp_path))
    assert len(asset.skeletons) == 1
    skel = asset.skeletons[0]
    assert skel.names == ["root", "bone"]
    assert skel.parents == [-1, 0]
    np.testing.assert_allclose(skel.bind_local_pos,
                               [[0, 0, 0], [0, 1, 0]], atol=1e-6)

    assert len(asset.meshes) == 1
    skin = asset.mesh_skin[0]
    assert skin is not None
    mesh = asset.meshes[0]
    # Every expanded vertex's weight: joint 1 iff its y == 2.
    for i, p in enumerate(mesh.positions):
        j = skin.joint_indices[i, 0]
        w = skin.joint_weights[i, 0]
        assert w == 1.0
        assert j == (1 if p[1] > 1.0 else 0)


def test_fbx_animation_drives_skinning(tmp_path):
    asset = load_fbx(_write(tmp_path))
    assert len(asset.animations) == 1
    clip_h = asset.animations[0]
    assert abs(clip_h.duration - 1.0) < 1e-6

    skel = asset.skeletons[0].to_skeleton()
    clip_h.looping = False   # sample the exact endpoint below
    clip = clip_h.to_clip()
    mesh = asset.meshes[0]
    skin = asset.mesh_skin[0]

    def skinned_at(t):
        pose = sample_clip(clip, jnp.asarray(t))
        wp, wr = forward_kinematics(skel, pose)
        sp, sr = skinning_transforms(skel, wp, wr)
        p, _ = skin_vertices(
            jnp.asarray(mesh.positions), jnp.asarray(mesh.normals),
            jnp.asarray(skin.joint_indices), jnp.asarray(skin.joint_weights),
            sp, sr)
        return np.asarray(p)

    # t=0: bind pose, vertices unchanged.
    np.testing.assert_allclose(skinned_at(0.0), mesh.positions, atol=1e-4)

    # t=1: bone rotated 90 deg about z around the pivot (0,1,0):
    # (0,2,0) -> (-1,1,0); (1,2,0) -> (-1,2,0).
    p1 = skinned_at(1.0)
    for i, p in enumerate(mesh.positions):
        if p[1] > 1.0:
            rel = p - np.array([0.0, 1.0, 0.0])
            expect = np.array([-rel[1], rel[0], rel[2]]) + [0.0, 1.0, 0.0]
            np.testing.assert_allclose(p1[i], expect, atol=1e-3)
        else:
            np.testing.assert_allclose(p1[i], p, atol=1e-4)


ASCII_DOC = """
; synthetic ASCII FBX (same scene as the binary writer)
Objects:  {
\tGeometry: 1000001, "Geometry::mesh", "Mesh" {
\t\tVertices: *12 {
\t\t\ta: 0,0,0,1,0,0,0,2,0,1,2,0
\t\t}
\t\tPolygonVertexIndex: *6 {
\t\t\ta: 0,1,-3,1,3,-3
\t\t}
\t}
\tModel: 3000001, "Model::root", "LimbNode" {
\t\tProperties70:  {
\t\t\tP: "Lcl Translation", "Lcl Translation", "", "A", 0, 0, 0
\t\t}
\t}
\tModel: 3000002, "Model::bone", "LimbNode" {
\t\tProperties70:  {
\t\t\tP: "Lcl Translation", "Lcl Translation", "", "A", 0, 1, 0
\t\t}
\t}
\tDeformer: 2000001, "Deformer::skin", "Skin" {
\t}
\tDeformer: 2000101, "Deformer::cl0", "Cluster" {
\t\tIndexes: *2 {
\t\t\ta: 0,1
\t\t}
\t\tWeights: *2 {
\t\t\ta: 1,1
\t\t}
\t}
\tDeformer: 2000102, "Deformer::cl1", "Cluster" {
\t\tIndexes: *2 {
\t\t\ta: 2,3
\t\t}
\t\tWeights: *2 {
\t\t\ta: 1,1
\t\t}
\t}
}
Connections:  {
\tC: "OO", 3000002, 3000001
\tC: "OO", 2000001, 1000001
\tC: "OO", 2000101, 2000001
\tC: "OO", 2000102, 2000001
\tC: "OO", 3000001, 2000101
\tC: "OO", 3000002, 2000102
}
"""


def test_fbx_ascii_import(tmp_path):
    path = tmp_path / "arm_ascii.fbx"
    path.write_text(ASCII_DOC)
    asset = load_fbx(str(path))
    assert len(asset.meshes) == 1
    assert len(asset.skeletons) == 1
    skel = asset.skeletons[0]
    assert skel.names == ["root", "bone"]
    assert skel.parents == [-1, 0]
    skin = asset.mesh_skin[0]
    assert skin is not None
    mesh = asset.meshes[0]
    for i, p in enumerate(mesh.positions):
        assert skin.joint_indices[i, 0] == (1 if p[1] > 1.0 else 0)


def test_fbx_ascii_parser_structure():
    root = parse_fbx_ascii(ASCII_DOC)
    objects = root.find("Objects")
    assert objects is not None
    geoms = objects.find_all("Geometry")
    assert len(geoms) == 1
    verts = geoms[0].find("Vertices").properties[0]
    assert len(verts) == 12
    models = objects.find_all("Model")
    assert [m.properties[2] for m in models] == ["LimbNode", "LimbNode"]
