"""Scene viewer — the web half of the editor substitute.

Reference: the editor's hierarchy/inspector/aux-texture panels and play-mode
loop (src/editor/editor.cpp:247, editor.h:45-51).  Two modes:

Static (default): a single self-contained HTML file with the entity tree and
all components, physics compilation stats, orbiting path-traced views, and
the intermediate render targets (AO / shadow / normals / depth) the
reference exposes as panels.

Live (`--serve`): a local HTTP loop — orbit/zoom the camera in the browser
(drag + wheel -> re-render request -> PNG response), inspect components,
and edit entity transforms; every edit goes through utils/undo.UndoStack,
so Undo/Redo work exactly like the reference's toggle-blob ring
(src/editor/undo_stack.h:6-40).

Usage:
  python tools/scene_viewer.py scene.yaml [--out scene.html] [--size 256]
      [--views 4] [--spp 6]
  python tools/scene_viewer.py scene.yaml --serve [--port 8710]
  python tools/scene_viewer.py --demo --serve        # built-in demo scene
"""

import argparse
import os
import sys

# Allow `python examples/x.py` / `python tools/x.py` without installing
# the package (the repo root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import base64
import html
import io
import json
import math
import sys
import threading

parser = argparse.ArgumentParser()
parser.add_argument("scene", nargs="?", default=None, help="scene YAML file")
parser.add_argument("--out", default=None)
parser.add_argument("--size", type=int, default=256)
parser.add_argument("--views", type=int, default=4)
parser.add_argument("--spp", type=int, default=6)
parser.add_argument("--orbit-radius", type=float, default=None)
parser.add_argument("--serve", action="store_true",
                    help="run the live HTTP viewer instead of writing HTML")
parser.add_argument("--port", type=int, default=8710)
parser.add_argument("--demo", action="store_true",
                    help="serve a built-in multi-object demo scene")
args = parser.parse_args()
if args.scene is None and not args.demo:
    parser.error("scene YAML required (or pass --demo)")
if args.views < 1 and not args.serve:
    parser.error("--views must be >= 1")

import jax
import jax.numpy as jnp
import numpy as np
from PIL import Image

from d3d12renderer_jax.scene import components as C
from d3d12renderer_jax.scene.scene import Scene
from d3d12renderer_jax.utils.undo import UndoStack


def png_bytes(arr_u8) -> bytes:
    img = Image.fromarray(np.asarray(arr_u8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def png_b64(arr_u8) -> str:
    return base64.b64encode(png_bytes(arr_u8)).decode()


def gray_u8(x):
    x = np.asarray(x, np.float64)
    finite = x[np.isfinite(x)]
    lo = finite.min() if finite.size else 0.0
    hi = finite.max() if finite.size else 1.0
    x = np.nan_to_num(x, nan=hi, posinf=hi, neginf=lo)
    n = (x - lo) / max(hi - lo, 1e-9)
    return (np.clip(n, 0, 1) * 255).astype(np.uint8)


def build_demo_scene() -> Scene:
    """Showcase-style multi-object scene through the ECS path."""
    s = Scene()
    s.add_static_plane((0, 1, 0), 0.0)
    # Dynamic bodies start above their rest height so play mode (clone +
    # physics step per frame) visibly drops them; the torus is static.
    specs = [
        ("RedSphere", "sphere", {"radius": 0.8}, (0.0, 2.2, 0.0),
         dict(albedo=(0.75, 0.15, 0.12), roughness=0.35),
         C.Collider(shape="sphere", size=(0.8,), restitution=0.4)),
        ("MetalSphere", "sphere", {"radius": 0.6}, (-1.9, 1.4, 0.7),
         dict(albedo=(0.95, 0.93, 0.88), roughness=0.12, metallic=1.0),
         C.Collider(shape="sphere", size=(0.6,))),
        ("BlueBox", "box", {"half_extents": (0.55, 0.55, 0.55)},
         (1.9, 1.3, -0.4), dict(albedo=(0.15, 0.3, 0.75), roughness=0.5),
         C.Collider(shape="box", size=(0.55, 0.55, 0.55))),
        ("GreenTorus", "torus", {"major": 0.8, "minor": 0.25},
         (0.7, 0.26, 1.9), dict(albedo=(0.2, 0.7, 0.3), roughness=0.4),
         None),
    ]
    for name, prim, params, pos, mat, col in specs:
        e = s.create_entity(name)
        e.add_component(C.Transform(position=pos))
        e.add_component(C.Mesh(primitive=prim, params=params))
        e.add_component(C.Material(**mat))
        if col is not None:
            e.add_component(C.RigidBody())
            e.add_component(col)
    ground = s.create_entity("GroundVis")
    ground.add_component(C.Transform())
    ground.add_component(C.Mesh(primitive="quad", params={"half": 12.0}))
    ground.add_component(C.Material(albedo=(0.45, 0.45, 0.45), roughness=0.7))
    # Motorized spinner: kinematic post + hinged paddle with a velocity
    # motor — the constraint-editing demo (reference: the inspector edits
    # constraint motors live, src/editor/editor.cpp).
    post = s.create_entity("Post")
    post.add_component(C.Transform(position=(-2.5, 0.6, -2.0)))
    post.add_component(C.Mesh(primitive="box",
                              params={"half_extents": (0.1, 0.6, 0.1)}))
    post.add_component(C.Material(albedo=(0.4, 0.35, 0.3)))
    post.add_component(C.RigidBody(kinematic=True))
    post.add_component(C.Collider(shape="box", size=(0.1, 0.6, 0.1)))
    paddle = s.create_entity("Paddle")
    paddle.add_component(C.Transform(position=(-2.5, 1.35, -2.0)))
    paddle.add_component(C.Mesh(primitive="box",
                                params={"half_extents": (0.5, 0.05, 0.12)}))
    paddle.add_component(C.Material(albedo=(0.8, 0.6, 0.2), roughness=0.3))
    paddle.add_component(C.RigidBody(gravity_factor=0.0, linear_damping=0.0,
                                     angular_damping=0.0))
    paddle.add_component(C.Collider(shape="box", size=(0.5, 0.05, 0.12),
                                    density=200.0))
    paddle.add_component(C.Joint(kind="hinge", other=post.id,
                                 anchor=(-2.5, 1.35, -2.0),
                                 axis=(0.0, 1.0, 0.0),
                                 motor_type="velocity", motor_target=0.0,
                                 motor_max=50.0))
    sun = s.create_entity("Sun")
    sun.add_component(C.DirectionalLight())
    return s


def orbit_camera(center, radius, theta, phi, aspect=1.0):
    from d3d12renderer_jax.render.camera import look_at

    phi = max(-1.45, min(1.45, phi))
    eye = center + np.array([
        math.cos(phi) * math.cos(theta), math.sin(phi),
        math.cos(phi) * math.sin(theta),
    ]) * radius
    return look_at(eye=tuple(eye), target=tuple(center + [0, 0.5, 0]),
                   aspect=aspect, v_fov=math.radians(50))


def scene_center_radius(rscene):
    tv = np.asarray(rscene.bvh.tri_v0[np.asarray(rscene.bvh.tri_valid)])
    center = tv.mean(0) if len(tv) else np.zeros(3)
    radius = args.orbit_radius or (
        float(2.2 * np.linalg.norm(tv - center, axis=-1).max())
        if len(tv) else 10.0)
    return center, radius


# ---------------------------------------------------------------------------
# Live server (--serve)
# ---------------------------------------------------------------------------

VIEWER_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>scene viewer</title><style>
body { font: 13px/1.5 system-ui, sans-serif; margin: 0; display: flex;
       background: #16181d; color: #d7dae0; height: 100vh; }
#left { flex: 1; display: flex; flex-direction: column; align-items: center;
        justify-content: center; }
#view { image-rendering: pixelated; border: 1px solid #333; cursor: grab;
        max-width: 90%; }
#side { width: 360px; overflow-y: auto; padding: 12px; border-left: 1px solid
        #2a2d34; }
button { background: #242832; color: #d7dae0; border: 1px solid #3a3f4b;
         border-radius: 4px; padding: 3px 10px; margin: 2px; cursor: pointer; }
button:hover { background: #2e3340; }
input[type=number] { width: 62px; background: #1b1e24; color: #d7dae0;
         border: 1px solid #3a3f4b; border-radius: 3px; }
select { background: #1b1e24; color: #d7dae0; border: 1px solid #3a3f4b; }
.ent { border-bottom: 1px solid #2a2d34; padding: 6px 0; }
.ent b { color: #9ecbff; } .comps { color: #8a8f98; font-size: 11px; }
#status { color: #8a8f98; font-size: 11px; margin-top: 6px; }
</style></head><body>
<div id="left"><img id="view" width="512" height="512">
  <div id="status">drag = orbit &middot; wheel = zoom</div></div>
<div id="side">
  <div>
    <button onclick="setMode('play')">&#9654;</button>
    <button onclick="setMode('pause')">&#9208;</button>
    <button onclick="setMode('stop')">&#9209;</button>
    <button onclick="act('undo')">&#8630; Undo</button>
    <button onclick="act('redo')">&#8631; Redo</button>
    target: <select id="kind" onchange="refresh()">
      <option>beauty</option><option>normals</option><option>depth</option>
      <option>ao</option></select>
    spp: <input id="spp" type="number" value="SPP0" min="1" max="64"
                onchange="refresh()">
  </div>
  <div id="ents"></div>
</div>
<script>
let theta = 0.8, phi = 0.45, radius = null, busy = false, dirty = false;
const view = document.getElementById('view');
function url() {
  let u = `/render?theta=${theta}&phi=${phi}` +
      `&kind=${document.getElementById('kind').value}` +
      `&spp=${document.getElementById('spp').value}`;
  if (radius !== null) u += `&radius=${radius}`;
  return u;
}
function refresh() {
  if (busy) { dirty = true; return; }
  busy = true;
  const t0 = performance.now();
  fetch(url()).then(r => r.blob()).then(b => {
    view.src = URL.createObjectURL(b);
    document.getElementById('status').textContent =
      `render ${(performance.now() - t0).toFixed(0)} ms`;
    busy = false;
    if (dirty) { dirty = false; refresh(); }
  }).catch(() => { busy = false; });
}
let drag = null;
view.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag) return;
  theta += (e.clientX - drag[0]) * 0.01;
  phi = Math.max(-1.4, Math.min(1.4, phi + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  refresh();
});
view.addEventListener('wheel', e => {
  e.preventDefault();
  fetch('/info').then(r => r.json()).then(j => {
    if (radius === null) radius = j.radius;
    radius *= Math.exp(e.deltaY * 0.001);
    refresh();
  });
}, { passive: false });
function act(what) {
  fetch('/' + what, { method: 'POST' })
    .then(r => r.json()).then(() => { loadEnts(); refresh(); });
}
let mode = 'edit';
function setMode(what) {
  fetch('/' + what, { method: 'POST' }).then(r => r.json()).then(j => {
    mode = j.mode;
    if (mode === 'play') playLoop(); else refresh();
  });
}
function playLoop() {
  if (mode !== 'play') return;
  if (busy) { setTimeout(playLoop, 30); return; }
  busy = true;
  fetch(url()).then(r => r.blob()).then(b => {
    view.src = URL.createObjectURL(b);
    busy = false;
    setTimeout(playLoop, 10);
  }).catch(() => { busy = false; });
}
function applyEdit(id) {
  const p = ['x', 'y', 'z'].map(a =>
    parseFloat(document.getElementById(`p_${id}_${a}`).value));
  fetch('/edit', { method: 'POST',
    headers: { 'Content-Type': 'application/json' },
    body: JSON.stringify({ id: id, position: p }) })
    .then(r => r.json()).then(() => refresh());
}
// Editable fields per component kind (the inspector's reach: materials,
// constraint motors/limits, lights, body params).
const EDITABLE = {
  material: ['albedo', 'emissive', 'roughness', 'metallic'],
  joint: ['motor_target', 'motor_max', 'limit_min', 'limit_max'],
  point_light: ['color', 'intensity', 'radius'],
  rigid_body: ['gravity_factor', 'linear_damping', 'angular_damping'],
};
function compEditor(e, comp, data, index) {
  const flds = EDITABLE[comp]; if (!flds) return '';
  const tag = (f, i, v) =>
    `<input type="number" step="0.1" value="${(+v).toFixed(2)}"
       data-e="${e.id}" data-c="${comp}" data-i="${index}" data-f="${f}"
       ${i === null ? '' : `data-vec="${i}"`}>`;
  let h = `<div class="comps">${comp}${index !== null ? '[' + index + ']' : ''}`;
  for (const f of flds) {
    const v = data[f];
    if (v === null || v === undefined) continue;
    if (Array.isArray(v)) h += ` ${f} ` + v.map((x, i) => tag(f, i, x)).join('');
    else if (typeof v === 'number') h += ` ${f} ` + tag(f, null, v);
  }
  return h + ` <button onclick="editComp(${e.id},'${comp}',${index})">
    apply</button></div>`;
}
function editComp(id, comp, index) {
  const fields = {};
  document.querySelectorAll(
    `input[data-e="${id}"][data-c="${comp}"][data-i="${index}"]`
  ).forEach(el => {
    const f = el.dataset.f, x = parseFloat(el.value);
    if (el.dataset.vec !== undefined)
      (fields[f] = fields[f] || [])[parseInt(el.dataset.vec)] = x;
    else fields[f] = x;
  });
  fetch('/edit', { method: 'POST',
    headers: { 'Content-Type': 'application/json' },
    body: JSON.stringify({ id: id, component: comp, index: index,
                           fields: fields }) })
    .then(r => r.json()).then(() => refresh());
}
function loadEnts() {
  fetch('/entities').then(r => r.json()).then(es => {
    const box = document.getElementById('ents');
    box.innerHTML = es.map(e => {
      let h = `<div class="ent"><b>${e.name}</b> <span class="comps">#${e.id}
        &middot; ${e.components.join(', ')}</span>`;
      if (e.position) {
        h += '<div>' + ['x', 'y', 'z'].map((a, i) =>
          `${a} <input id="p_${e.id}_${a}" type="number" step="0.1"
             value="${e.position[i].toFixed(2)}">`).join(' ') +
          ` <button onclick="applyEdit(${e.id})">move</button></div>`;
      }
      for (const comp in (e.detail || {})) {
        const d = e.detail[comp];
        if (Array.isArray(d)) d.forEach((c, i) => h += compEditor(e, comp, c, i));
        else h += compEditor(e, comp, d, null);
      }
      h += '</div>';
      return h;
    }).join('');
  });
}
loadEnts(); refresh();
</script></body></html>"""


def serve(scene: Scene, port: int):
    from functools import lru_cache
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    from d3d12renderer_jax.render import post as post_mod
    from d3d12renderer_jax.render.gbuffer import render_gbuffer
    from d3d12renderer_jax.render.pathtracer import (
        PathTracerSettings, render, to_srgb_u8,
    )

    from d3d12renderer_jax.physics import step as step_mod
    from d3d12renderer_jax.physics.types import PhysicsSettings

    undo = UndoStack()
    lock = threading.Lock()          # one render / edit at a time
    cache = {"rscene": None}
    # Play mode (reference: editor_scene play/pause/stop with scene cloning,
    # src/scene/scene.h:399-463 + editor.cpp): `play` clones the editor
    # scene, compiles its physics, and each /render in play mode advances
    # the CLONE one 1/60 s frame; `stop` discards the clone — the editor
    # scene is untouched.
    play = {"mode": "edit", "scene": None, "arch": None, "state": None,
            "mapping": None, "stepper": None, "mo": None, "frames": 0}

    def rscene():
        if cache["rscene"] is None:
            cache["rscene"] = scene.build_render_scene()
        return cache["rscene"]

    def invalidate():
        cache["rscene"] = None

    def start_play():
        if play["mode"] != "edit":      # pause -> resume
            play["mode"] = "play"
            return
        clone = scene.clone()
        arch, state, mapping = clone.compile_physics()
        play.update(scene=clone, arch=arch, state=state, mapping=mapping,
                    stepper=_make_stepper(arch),
                    mo=tuple(dict(t.params) for t in arch.joints),
                    frames=0, mode="play")

    def _make_stepper(arch):
        # arch is closed over (the solver extracts host constants from it);
        # joint PARAMETER arrays ride the `mo` jit argument, so live
        # motor/limit edits hit the jit cache (reference: the inspector
        # edits constraint motors during play, editor.cpp).
        settings = PhysicsSettings()
        return jax.jit(lambda s, mo: step_mod.physics_step(
            arch, s, settings, 1.0 / 60.0, motor_overrides=mo or None)[0])

    def stop_play():
        play.update(mode="edit", scene=None, arch=None, state=None,
                    mapping=None, stepper=None, mo=None, frames=0)

    def play_rscene(advance: bool):
        if advance:
            play["state"] = play["stepper"](play["state"], play["mo"])
            play["frames"] += 1
        return play["scene"].build_render_scene(
            body_state=play["state"], mapping=play["mapping"])

    @lru_cache(maxsize=8)
    def beauty_fn(size, spp):
        return jax.jit(lambda sc, cam, key: to_srgb_u8(render(
            sc, cam, size, size, PathTracerSettings(recursion_depth=2),
            spp=spp, key=key)))

    def render_png(q):
        theta = float(q.get("theta", ["0.8"])[0])
        phi = float(q.get("phi", ["0.45"])[0])
        size = int(q.get("size", [str(args.size)])[0])
        spp = int(q.get("spp", [str(args.spp)])[0])
        kind = q.get("kind", ["beauty"])[0]
        if play["mode"] in ("play", "pause"):
            rs = play_rscene(advance=play["mode"] == "play")
        else:
            rs = rscene()
        center, radius = scene_center_radius(rs)
        if "radius" in q:
            radius = float(q["radius"][0])
        cam = orbit_camera(center, radius, theta, phi)
        if kind == "beauty":
            img = beauty_fn(size, spp)(rs, cam, jax.random.PRNGKey(0))
            return png_bytes(np.asarray(img))
        gb = render_gbuffer(rs, cam, size, size)
        if kind == "normals":
            return png_bytes(((np.asarray(gb.normal) * 0.5 + 0.5)
                              * 255).astype(np.uint8))
        if kind == "depth":
            return png_bytes(gray_u8(np.asarray(gb.depth)))
        if kind == "ao":
            return png_bytes(gray_u8(
                np.asarray(post_mod.hbao(gb.view_pos, gb.view_normal))))
        raise ValueError(f"unknown render kind {kind!r}")

    def entities_json():
        out = []
        for ent, _ in scene.view():
            comps = [k for k in scene._components if ent.has(k)]
            row = {"id": ent.id, "name": ent.name, "components": comps,
                   "detail": {}}
            tf = ent.get("transform")
            if tf is not None:
                row["position"] = [float(x) for x in tf.position]
                row["rotation"] = [float(x) for x in tf.rotation]
            # Full component reflection (the reference inspector edits every
            # component, editor.cpp drawComponent loops): dataclass fields
            # serialize for the side panel; list components (collider,
            # joint) serialize per element.
            for k in comps:
                v = scene._components[k][ent.id]
                if isinstance(v, list):
                    row["detail"][k] = [C.to_plain(c) for c in v]
                else:
                    row["detail"][k] = C.to_plain(v)
            out.append(row)
        return out

    def _comp_slot(sc, eid, kind, index):
        """(store, current value) for a component slot on a scene."""
        store = sc._components.get(kind, {})
        if eid not in store:
            raise KeyError(f"entity {eid} has no {kind}")
        cur = store[eid]
        if isinstance(cur, list):
            if index is None or not (0 <= index < len(cur)):
                raise KeyError(f"{kind} index {index} out of range")
        return store, cur

    def _set_comp(sc, eid, kind, index, new):
        store, cur = _comp_slot(sc, eid, kind, index)
        if isinstance(cur, list):
            old = cur[index]
            cur[index] = new
        else:
            old = cur
            store[eid] = new
        return old

    def _rebuild_play_arch(kind="joint"):
        """Recompile the play clone's physics tables after a live edit,
        KEEPING the running body state (identical shapes: the edit changed
        parameter values, not the body/joint layout).  Joint edits flow in
        through the stepper's motor_overrides argument — jit cache hit, the
        very next frame uses the new motors; body/collider edits change
        closed-over arch arrays and rebuild the stepper (one retrace)."""
        arch2, _, mapping2 = play["scene"].compile_physics()
        play["arch"] = arch2
        play["mapping"] = mapping2
        play["mo"] = tuple(dict(t.params) for t in arch2.joints)
        if kind != "joint":
            play["stepper"] = _make_stepper(arch2)

    def make_toggle(eid, kind, index):
        def toggle(saved):
            replaced = _set_comp(scene, eid, kind, index, saved)
            if play["mode"] != "edit" and play["scene"] is not None:
                _set_comp(play["scene"], eid, kind, index, saved)
                _rebuild_play_arch(kind)
            invalidate()
            return replaced
        return toggle

    def apply_edit(doc):
        """Edit any component's fields with undo.

        {"id": eid, "component": kind, "index": i?, "fields": {...}} —
        or the legacy transform shorthand {"id", "position"/"rotation"/
        "scale"}.  During play/pause, edits apply to BOTH the editor scene
        and the running clone; physics-affecting components rebuild the
        clone's tables in place (live motor retargeting, matching the
        reference inspector's constraint editing)."""
        import dataclasses

        eid = int(doc["id"])
        kind = doc.get("component", "transform")
        index = doc.get("index")
        if "fields" in doc:
            fields = doc["fields"]
        else:  # legacy transform shorthand
            fields = {k: doc[k] for k in ("position", "rotation", "scale")
                      if k in doc}
        _, cur = _comp_slot(scene, eid, kind, index)
        old = cur[index] if isinstance(cur, list) else cur
        valid = {f.name: f.type for f in dataclasses.fields(old)}
        changes = {}
        for k, v in fields.items():
            if k not in valid:
                raise KeyError(f"{kind} has no field {k!r}")
            proto = getattr(old, k)
            if isinstance(v, list):
                v = tuple(float(x) for x in v)
            elif isinstance(proto, bool):
                v = bool(v)
            elif isinstance(proto, int) and not isinstance(proto, bool):
                v = int(v)
            elif isinstance(proto, float):
                v = float(v)
            changes[k] = v
        new = dataclasses.replace(old, **changes)
        if kind == "transform" and play["mode"] != "edit":
            raise RuntimeError("stop playback to move entities")
        name = scene._names.get(eid, f"entity{eid}")
        undo.push(f"edit {name}", old, make_toggle(eid, kind, index))
        _set_comp(scene, eid, kind, index, new)
        if play["mode"] != "edit" and play["scene"] is not None:
            _set_comp(play["scene"], eid, kind, index, new)
            if kind in ("joint", "rigid_body", "collider"):
                _rebuild_play_arch(kind)
        invalidate()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

        def do_GET(self):
            u = urlparse(self.path)
            try:
                if u.path == "/":
                    page = VIEWER_HTML.replace("SPP0", str(args.spp))
                    self._send(200, page.encode(), "text/html")
                elif u.path == "/render":
                    with lock:
                        body = render_png(parse_qs(u.query))
                    self._send(200, body, "image/png")
                elif u.path == "/entities":
                    self._send(200, json.dumps(entities_json()).encode())
                elif u.path == "/info":
                    with lock:
                        center, radius = scene_center_radius(rscene())
                    self._send(200, json.dumps({
                        "radius": radius,
                        "center": [float(x) for x in center],
                        "undo": undo.undo_name, "redo": undo.redo_name,
                        "mode": play["mode"], "frames": play["frames"],
                    }).encode())
                elif u.path == "/physics":
                    # Play-mode body state (position/velocity per entity):
                    # the live-edit observability hook (reference: the
                    # editor reads back rigid-body state every frame).
                    with lock:
                        if play["mode"] == "edit" or play["state"] is None:
                            raise RuntimeError("not playing")
                        st = play["state"]
                        rows = {}
                        for eid, b in play["mapping"].items():
                            rows[str(eid)] = {
                                "position":
                                    np.asarray(st.pos[b]).tolist(),
                                "lin_vel":
                                    np.asarray(st.vel[b]).tolist(),
                                "ang_vel":
                                    np.asarray(st.omega[b]).tolist(),
                            }
                    self._send(200, json.dumps(
                        {"frames": play["frames"], "bodies": rows}).encode())
                else:
                    self._send(404, b"{}")
            except Exception as e:  # surface errors to the client
                self._send(500, json.dumps({"error": str(e)}).encode())

        def do_POST(self):
            u = urlparse(self.path)
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b"{}"
            try:
                if u.path == "/edit":
                    with lock:
                        apply_edit(json.loads(raw))
                    self._send(200, b'{"ok": true}')
                elif u.path == "/play":
                    with lock:
                        start_play()
                    self._send(200, json.dumps(
                        {"mode": play["mode"]}).encode())
                elif u.path == "/pause":
                    with lock:
                        if play["mode"] == "play":
                            play["mode"] = "pause"
                    self._send(200, json.dumps(
                        {"mode": play["mode"]}).encode())
                elif u.path == "/stop":
                    with lock:
                        stop_play()
                    self._send(200, json.dumps(
                        {"mode": play["mode"]}).encode())
                elif u.path == "/undo":
                    with lock:
                        name = undo.undo()
                    self._send(200, json.dumps({"undone": name}).encode())
                elif u.path == "/redo":
                    with lock:
                        name = undo.redo()
                    self._send(200, json.dumps({"redone": name}).encode())
                else:
                    self._send(404, b"{}")
            except Exception as e:
                self._send(500, json.dumps({"error": str(e)}).encode())

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    print(f"serving on http://127.0.0.1:{httpd.server_address[1]}/ "
          f"(ctrl-c to stop)", flush=True)
    httpd.serve_forever()


# ---------------------------------------------------------------------------
# Static HTML (default mode)
# ---------------------------------------------------------------------------

def write_static(scene: Scene):
    arch, state, mapping = scene.compile_physics()
    rscene = scene.build_render_scene(body_state=state, mapping=mapping)
    center, radius = scene_center_radius(rscene)

    from d3d12renderer_jax.render.gbuffer import render_gbuffer
    from d3d12renderer_jax.render.pathtracer import (
        PathTracerSettings, render, to_srgb_u8,
    )

    views = []
    aux = []
    for i in range(args.views):
        ang = 2 * math.pi * i / args.views
        cam = orbit_camera(center, radius, ang, math.asin(0.5 / math.sqrt(1.25)))
        img = render(rscene, cam, args.size, args.size,
                     PathTracerSettings(recursion_depth=2), spp=args.spp,
                     key=jax.random.PRNGKey(i))
        views.append((f"orbit {i * 360 // args.views}&deg;",
                      png_b64(to_srgb_u8(img))))
        if i == 0:
            # Aux buffers from the first view (the editor's texture panels).
            gb = render_gbuffer(rscene, cam, args.size, args.size)
            from d3d12renderer_jax.render import post
            ao = post.hbao(gb.view_pos, gb.view_normal)
            aux = [
                ("normals", png_b64(((np.asarray(gb.normal) * 0.5 + 0.5)
                                     * 255).astype(np.uint8))),
                ("depth", png_b64(gray_u8(np.asarray(gb.depth)))),
                ("object id", png_b64(gray_u8(np.asarray(gb.object_id)))),
                ("AO", png_b64(gray_u8(np.asarray(ao)))),
            ]

    # Entity tree.
    rows = []
    for ent, _ in scene.view():
        comps = [k for k in scene._components if ent.has(k)]
        detail = []
        for k in comps:
            v = ent.get(k)
            if k == "transform":
                detail.append(
                    f"transform: pos="
                    f"{tuple(round(float(x), 3) for x in v.position)}")
            elif k == "collider":
                for c in v:
                    detail.append(f"collider: {c.shape} size={tuple(c.size)}")
            else:
                detail.append(f"{k}: {html.escape(str(v)[:120])}")
        rows.append((ent.id, ent.name, comps, detail))

    total_pairs = sum(b.body_a.shape[0] for b in arch.contact_buckets)
    joints = [(t.kind, t.body_a.shape[0]) for t in arch.joints]

    parts = [f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(args.scene)}</title><style>
body {{ font: 13px/1.5 system-ui, sans-serif; margin: 24px; background: #16181d; color: #d7dae0; }}
h1, h2 {{ font-weight: 600; }} code {{ color: #9ecbff; }}
.imgs img {{ image-rendering: pixelated; margin: 4px; border: 1px solid #333; }}
.cap {{ color: #8a8f98; font-size: 11px; text-align: center; }}
table {{ border-collapse: collapse; }} td, th {{ padding: 2px 10px; border-bottom: 1px solid #2a2d34; text-align: left; vertical-align: top; }}
details {{ margin-left: 8px; }} .cell {{ display: inline-block; }}
</style></head><body>
<h1>Scene: <code>{html.escape(args.scene)}</code></h1>
<h2>Views (path traced)</h2><div class="imgs">"""]
    for cap, b64 in views:
        parts.append(f'<span class="cell"><img width="{args.size}" '
                     f'src="data:image/png;base64,{b64}"><div class="cap">'
                     f'{cap}</div></span>')
    parts.append('</div><h2>Render targets (first view)</h2>'
                 '<div class="imgs">')
    for cap, b64 in aux:
        parts.append(f'<span class="cell"><img width="{args.size}" '
                     f'src="data:image/png;base64,{b64}"><div class="cap">'
                     f'{cap}</div></span>')
    parts.append(f"""</div>
<h2>Physics</h2>
<p>{arch.num_bodies} bodies &middot; {arch.num_colliders} colliders &middot;
{arch.num_planes} planes &middot; {arch.num_terrains} terrains &middot;
{arch.vs_plane_collider.shape[0]} plane rows &middot; {total_pairs} pair rows
&middot; joints: {", ".join(f"{n} {k}" for k, n in joints) or "none"}</p>
<h2>Entities ({len(rows)})</h2><table>
<tr><th>id</th><th>name</th><th>components</th></tr>""")
    for eid, name, comps, detail in rows:
        d = "<br>".join(html.escape(x) if not x.startswith("transform")
                        else x for x in detail)
        parts.append(f"<tr><td>{eid}</td><td>{html.escape(name)}</td>"
                     f"<td><details><summary>{', '.join(comps)}</summary>"
                     f"{d}</details></td></tr>")
    parts.append("</table></body></html>")

    out = args.out or (args.scene.rsplit(".", 1)[0] + ".html")
    with open(out, "w") as f:
        f.write("".join(parts))
    print(f"wrote {out} ({len(rows)} entities, {len(views)} views)")


if __name__ == "__main__":
    scene = (build_demo_scene() if args.demo
             else Scene.load_yaml(args.scene))
    if args.serve:
        serve(scene, args.port)
    else:
        if args.scene is None:
            args.scene = "demo"
        write_static(scene)
