"""Live HTTP viewer: the headless replacement for the reference's
on-screen display docks.

Counterpart of ``octproz_tpu/viz/live.py``: the same page (its title
aside), endpoints, throttles and engine hooks.  The volume raycast runs on
the device of the model it is attached to (the constructor's ``device``
until then), on a CUDA stream the viewer draws once from PyTorch's pool
-- not the engine thread's current stream, where the steps run, and
distinct from the engine's upload and D2H streams unless 32 pool streams
were drawn in between (the pool hands its streams out in turn) -- and
only that stream is synchronized before the image is encoded.  Each
thread that renders (the engine's drain thread, an HTTP thread) passes
that stream to the renderer, since torch's current stream is per thread.
A render that fails raises on the thread that asked for it.  PNGs are
encoded by ``viz.image.encode_png`` (no Pillow).

The reference renders into OpenGL windows on the acquisition workstation
(GLWindow2D B-scan/en-face, octproz_project/octproz/src/glwindow2d.{h,cpp};
1-D raw/processed line plots, src/plotwindow1d.{h,cpp}; the 5-second
throughput info box, src/processing.cpp:193-207).  A GPU server has no
display and is usually remote, so the equivalent here is a tiny
zero-dependency HTTP server (stdlib ``http.server``) that any browser on
the network can watch:

  /             one-page viewer (auto-refreshing images + live stats +
                parameter controls)
  /bscan.png    latest B-scan display frame (averaging/MIP over adjacent
                frames, cuda_code.cu:810-866 semantics) through a color LUT
  /enface.png   latest en-face display frame (cuda_code.cu:868-912)
  /volume.png   periodic 3D render of the assembled volume
                (updateDisplayedVolume analog, cuda_code.cu:914-941)
  /ascan.json   centre A-scan of the latest frame (PlotWindow1D analog)
  /stats.json   throughput metrics window (info-box analog)
  /params.json  current re-tunable parameters (sidebar state analog)
  POST /control live parameter re-tuning: {"command": ..., ...} routed to a
                ParamController (sidebar-edit / plugin-request analog,
                SURVEY.md section 3.5, plugin.h:82-84)

Frame updates are throttled like the reference's 80 ms redraw timer
(glwindow3d.cpp:316-323): between ticks, incoming volumes only replace the
pending frame.  The 2-D frames are host-side numpy; the throttled volume
raycast is the one device job of the viewer.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from .image import apply_lut, builtin_lut, encode_png, to_uint8

_PAGE = """<!doctype html>
<html><head><title>octproz_tpu_torch live</title><style>
 body{background:#111;color:#ddd;font-family:sans-serif;margin:1em}
 img{image-rendering:pixelated;border:1px solid #333;max-width:31vw}
 #stats{font-family:monospace;white-space:pre}
 canvas{border:1px solid #333;background:#000}
 .view{display:inline-block;vertical-align:top;margin-right:8px}
 .view .bar{font-family:monospace;font-size:11px;color:#9ab}
 input{width:4.5em;background:#222;color:#ddd;border:1px solid #444}
 select{background:#222;color:#ddd;border:1px solid #444}
 button{background:#234;color:#ddd;border:1px solid #456;margin:2px}
 #ctlmsg{font-family:monospace;color:#8c8}
 #exts div{font-family:monospace}
</style></head><body>
<h2>octproz_tpu_torch live view</h2>
<div id="stats">waiting for data...</div>
<div>
 <div class="view"><canvas id="bscanC" width="420" height="420"></canvas>
   <div class="bar" id="bscanBar">B-scan &#8212; wheel: zoom, drag: pan,
    dblclick: marker, r: rotate</div></div>
 <div class="view"><canvas id="enfaceC" width="420" height="420"></canvas>
   <div class="bar" id="enfaceBar">en-face</div></div>
 <div class="view" id="volPane" style="display:none">
  <img id="volume" alt="volume" draggable="false" style="cursor:grab">
  <div class="bar">volume &#8212; drag: rotate</div>
  <div class="bar">mode <select id="vmode"></select>
   thr <input id="vthr"> gamma <input id="vgamma">
   step <input id="vstep">
   lut <select id="vlut"><option>gray</option><option>fire</option>
    <option>hotter</option><option>ice</option><option>blue</option>
    <option>deep_blue</option><option>deep_red</option>
    <option>six_shades</option><option>sixteen_colors</option>
    <option>depth_colors</option></select>
   <button onclick="applyRender()">apply</button></div>
 </div>
 <img id="camera" alt="camera" style="display:none">
 <img id="bscan" style="display:none"> <img id="enface" style="display:none">
</div>
<h3>centre A-scan</h3><canvas id="ascan" width="600" height="160"></canvas>
<div id="ctl"><h3>live re-tuning</h3>
 <div>dispersion d0-d3:
  <input id="d0"><input id="d1"><input id="d2"><input id="d3">
  <button onclick="setCoeffs('set_dispersion_coeffs','d')">apply</button></div>
 <div>k-lin c0-c3:
  <input id="c0"><input id="c1"><input id="c2"><input id="c3">
  <button onclick="setCoeffs('set_klin_coeffs','c')">apply</button></div>
 <div>window: <select id="wtype"><option>hanning</option><option>gauss</option>
   <option>sine</option><option>lanczos</option><option>rectangular</option>
   <option>flattop</option><option>taylor</option></select>
  center <input id="wcenter"> fill <input id="wfill">
  <button onclick="setWindow()">apply</button></div>
 <div>interpolation: <select id="interp"><option>linear</option>
   <option>quadratic</option><option>cubic</option><option>lanczos</option>
  </select>
  <button onclick="post({command:'set_interpolation',
    type:val('interp')})">apply (recompiles)</button>
  FPN: <select id="fpn"><option>off</option><option>once</option>
   <option>continuous</option></select>
  <button onclick="post({command:'set_fpn_mode',mode:val('fpn')})">
   apply (recompiles)</button></div>
 <div>grayscale min/max:
  <input id="gmin"><input id="gmax">
  <button onclick="setGray()">apply (recompiles)</button>
  <button onclick="post({command:'redetermine_fpn'})">redetermine FPN</button>
  <button onclick="post({command:'record_post_background',n:1})">record background</button></div>
 <div>streaming: skip <input id="skip">
  <button onclick="post({command:'set_streaming',
    skip:parseInt(val('skip'))||0, enabled:true})">apply</button>
  recording: <input id="recname" value="live"> x<input id="recn" value="4">
  <button onclick="post({command:'start_recording', name:val('recname'),
    buffers:parseInt(val('recn'))||1, dir:'.'})">record</button>
  <span id="recstate"></span></div>
 <div>display: B-scan <input id="dbscan" value="0">
  en-face depth <input id="ddepth" value="0">
  frames <input id="dframes" value="1">
  <select id="dmode"><option value="avg">average</option>
   <option value="mip">MIP</option></select>
  depth mm <input id="dmm"> width mm <input id="wmm">
  <button onclick="setDisplay()">apply</button></div>
 <div id="ctlmsg"></div></div>
<div id="exts"><h3>extensions</h3><div id="extlist"></div>
 <div id="extpanes"></div></div>
<script>
function val(id){ return document.getElementById(id).value; }
async function post(obj){
  try {
    const r = await (await fetch('/control', {method:'POST',
      body: JSON.stringify(obj)})).json();
    document.getElementById('ctlmsg').textContent = JSON.stringify(r);
  } catch(e){ document.getElementById('ctlmsg').textContent = e; }
}
function setCoeffs(cmd, p){
  const o = {command: cmd};
  for (let i = 0; i < 4; i++)
    o[p+i] = parseFloat(document.getElementById(p+i).value) || 0;
  post(o);
}
function setGray(){
  post({command:'set_grayscale', min: parseFloat(val('gmin')) || 0,
        max: parseFloat(val('gmax')) || 1});
}
function setWindow(){
  post({command:'set_window', type: val('wtype'),
        center: parseFloat(val('wcenter')) || 0.5,
        fill_factor: parseFloat(val('wfill')) || 1});
}
async function setDisplay(){
  const o = {bscan_nr: parseInt(val('dbscan'))||0,
             enface_depth: parseInt(val('ddepth'))||0,
             frames: parseInt(val('dframes'))||1,
             mip: val('dmode')=='mip'};
  const dmm = parseFloat(val('dmm')); if (dmm) o.depth_mm = dmm;
  const wmm = parseFloat(val('wmm')); if (wmm) o.width_mm = wmm;
  const r = await (await fetch('/display', {method:'POST',
    body: JSON.stringify(o)})).json();
  if (r.reply){ bview.mm = r.reply.depth_mm || 0;
                eview.mm = r.reply.width_mm || 0; }
  document.getElementById('ctlmsg').textContent = JSON.stringify(r);
}
// ---- interactive 2-D views (GLWindow2D analog: zoom/pan/rotate/stretch,
//      scale bar, marker lines, data cursor, FPS counter) ----
function makeView(cname, iname){
  const c = document.getElementById(cname), g = c.getContext('2d');
  const img = document.getElementById(iname);
  const v = {zoom: 1, ox: 0, oy: 0, rot: 0, marker: null, cursor: null,
             frames: 0, fps: 0, lastT: Date.now(), mm: 0, hover: false};
  function draw(){
    g.setTransform(1,0,0,1,0,0);
    g.clearRect(0,0,c.width,c.height);
    if (!img.naturalWidth) return;
    g.save();
    g.translate(c.width/2 + v.ox, c.height/2 + v.oy);
    g.rotate(v.rot * Math.PI/180);
    const s = v.zoom * Math.min(c.width/img.naturalWidth,
                                c.height/img.naturalHeight);
    g.scale(s, s);
    g.imageSmoothingEnabled = false;
    g.drawImage(img, -img.naturalWidth/2, -img.naturalHeight/2);
    if (v.marker){  // marker overlay lines through the marked pixel
      g.strokeStyle = 'rgba(255,220,0,0.8)'; g.lineWidth = 1/s;
      g.beginPath();
      g.moveTo(-img.naturalWidth/2, v.marker.y - img.naturalHeight/2);
      g.lineTo(img.naturalWidth/2, v.marker.y - img.naturalHeight/2);
      g.moveTo(v.marker.x - img.naturalWidth/2, -img.naturalHeight/2);
      g.lineTo(v.marker.x - img.naturalWidth/2, img.naturalHeight/2);
      g.stroke();
    }
    g.restore();
    if (v.mm && img.naturalHeight){  // scale bar (1/4 of the view)
      const mmPerPx = v.mm / img.naturalHeight;
      const px = c.height/4, mm = mmPerPx * px / (v.zoom *
        Math.min(c.width/img.naturalWidth, c.height/img.naturalHeight));
      g.strokeStyle = '#fff'; g.fillStyle = '#fff'; g.lineWidth = 2;
      g.beginPath(); g.moveTo(12, c.height-14);
      g.lineTo(12, c.height-14-px); g.stroke();
      g.font = '11px monospace';
      g.fillText(mm.toFixed(2)+' mm', 16, c.height-14-px/2);
    }
    g.fillStyle = '#8f8'; g.font = '11px monospace';
    g.fillText(v.fps.toFixed(1)+' fps', c.width-58, 14);
  }
  function toImage(e){
    const r = c.getBoundingClientRect();
    const cx = e.clientX - r.left - c.width/2 - v.ox;
    const cy = e.clientY - r.top - c.height/2 - v.oy;
    const a = -v.rot * Math.PI/180;
    const rx = cx*Math.cos(a) - cy*Math.sin(a);
    const ry = cx*Math.sin(a) + cy*Math.cos(a);
    const s = v.zoom * Math.min(c.width/img.naturalWidth,
                                c.height/img.naturalHeight);
    return {x: Math.round(rx/s + img.naturalWidth/2),
            y: Math.round(ry/s + img.naturalHeight/2)};
  }
  c.addEventListener('wheel', e => { e.preventDefault();
    v.zoom *= e.deltaY < 0 ? 1.15 : 1/1.15; draw(); });
  let drag = null;
  c.addEventListener('mousedown', e => drag = {x: e.clientX, y: e.clientY});
  window.addEventListener('mouseup', () => drag = null);
  c.addEventListener('mousemove', async e => {
    if (drag){ v.ox += e.clientX - drag.x; v.oy += e.clientY - drag.y;
               drag = {x: e.clientX, y: e.clientY}; draw(); return; }
    const p = toImage(e);
    if (p.x >= 0 && p.y >= 0 && p.x < img.naturalWidth &&
        p.y < img.naturalHeight && !v.fetching){
      v.fetching = true;  // data cursor: value readout from the server
      try {
        const r = await (await fetch('/pixel?img=' +
          (cname=='bscanC'?'bscan':'enface') + '&x='+p.x+'&y='+p.y)).json();
        document.getElementById(cname=='bscanC'?'bscanBar':'enfaceBar')
          .textContent = '('+p.x+', '+p.y+') = ' +
            (r.value==null?'-':r.value.toFixed(4));
      } catch(err){}
      v.fetching = false;
    }
  });
  c.addEventListener('dblclick', e => {
    const p = toImage(e);
    v.marker = (v.marker && v.marker.x==p.x && v.marker.y==p.y) ? null : p;
    draw();
  });
  c.addEventListener('mouseenter', () => v.hover = true);
  c.addEventListener('mouseleave', () => v.hover = false);
  window.addEventListener('keydown', e => {
    // only when this view is hovered AND focus isn't in a form field:
    // typing '0' into an input must not reset the canvases
    if (!v.hover || ['INPUT','SELECT','TEXTAREA','BUTTON']
        .includes((e.target.tagName||'').toUpperCase())) return;
    if (e.key=='r'){ v.rot = (v.rot + 90) % 360; draw(); }
    if (e.key=='0'){ v.zoom = 1; v.ox = v.oy = 0; v.rot = 0; draw(); }
  });
  img.addEventListener('load', () => {
    const now = Date.now();
    v.frames++; v.fps = 0.8*v.fps + 0.2*(1000/Math.max(1, now-v.lastT));
    v.lastT = now; draw();
  });
  return v;
}
const bview = makeView('bscanC','bscan'), eview = makeView('enfaceC','enface');
// ---- interactive 3-D volume view (GLWindow3D analog: trackball rotation
//      + per-frame mode uniforms via POST /render) ----
const vstate = {yaw: 0.5, pitch: 0.4, seeded: false, posting: false,
                pendYaw: 0, pendPitch: 0};
async function postRender(obj){
  if (vstate.posting) return null;       // one in-flight raycast at a time
  vstate.posting = true;
  try {
    const r = await (await fetch('/render', {method:'POST',
      body: JSON.stringify(obj)})).json();
    if (r.reply){ vstate.yaw = r.reply.yaw; vstate.pitch = r.reply.pitch;
      document.getElementById('volume').src = '/volume.png?' + Date.now(); }
    return r;
  } catch(e){ return null; }
  finally {
    vstate.posting = false;
    // pointer motion accumulated while this raycast was in flight is not
    // lost: flush it as the next rotation post
    if (vstate.pendYaw || vstate.pendPitch){
      const dy = vstate.pendYaw, dp = vstate.pendPitch;
      vstate.pendYaw = vstate.pendPitch = 0;
      postRender({yaw: vstate.yaw + dy,
        pitch: Math.max(-1.5, Math.min(1.5, vstate.pitch + dp))});
    }
  }
}
function applyRender(){
  postRender({mode: val('vmode'),
              threshold: parseFloat(val('vthr')) || 0,
              gamma: parseFloat(val('vgamma')) || 1,
              step_length: parseFloat(val('vstep')) || 0.02,
              lut: val('vlut')});
}
async function seedRender(){
  try {
    const s = await (await fetch('/render.json')).json();
    const ms = document.getElementById('vmode');
    ms.innerHTML = '';
    for (const m of s.modes || []){
      const o = document.createElement('option');
      o.value = o.textContent = m; ms.appendChild(o);
    }
    ms.value = s.mode;
    document.getElementById('vthr').value = s.threshold;
    document.getElementById('vgamma').value = s.gamma;
    document.getElementById('vstep').value = s.step_length;
    document.getElementById('vlut').value = s.lut || 'gray';
    vstate.yaw = s.yaw; vstate.pitch = s.pitch;
    vstate.seeded = true;
  } catch(e){}
}
(function(){
  const img = document.getElementById('volume');
  let drag = null;
  img.addEventListener('pointerdown', e => { e.preventDefault();
    drag = {x: e.clientX, y: e.clientY}; img.style.cursor = 'grabbing'; });
  window.addEventListener('pointerup', () => {
    if (drag) img.style.cursor = 'grab';
    drag = null; });
  window.addEventListener('pointermove', e => {
    if (!drag) return;
    const dy = e.clientX - drag.x, dp = e.clientY - drag.y;
    if (!dy && !dp) return;
    drag = {x: e.clientX, y: e.clientY};
    // trackball sensitivity ~0.008 rad/px; pitch clamped near the poles.
    // While a raycast is in flight the delta ACCUMULATES (postRender
    // flushes it on completion) so rotation tracks total drag travel
    // regardless of raycast latency.
    if (vstate.posting){
      vstate.pendYaw += dy*0.008; vstate.pendPitch += dp*0.008;
      return;
    }
    postRender({yaw: vstate.yaw + dy*0.008,
      pitch: Math.max(-1.5, Math.min(1.5, vstate.pitch + dp*0.008))});
  });
})();
let seeded = false;
async function seed(){
  try {
    const p = await (await fetch('/params.json')).json();
    if (!p.klin_coeffs) return;
    for (let i = 0; i < 4; i++){
      document.getElementById('c'+i).value = p.klin_coeffs[i];
      document.getElementById('d'+i).value = p.dispersion_coeffs[i];
    }
    document.getElementById('gmin').value = p.grayscale_min;
    document.getElementById('gmax').value = p.grayscale_max;
    document.getElementById('wtype').value = p.window_type;
    document.getElementById('wcenter').value = p.window_center;
    document.getElementById('wfill').value = p.window_fill_factor;
    document.getElementById('interp').value = p.interpolation;
    document.getElementById('fpn').value = p.fpn_mode;
    if (p.streaming_skip != null)
      document.getElementById('skip').value = p.streaming_skip;
    const d = await (await fetch('/display.json')).json();
    // B-scan vertical axis = depth; en-face vertical axis = slow scan
    bview.mm = d.depth_mm || 0; eview.mm = d.width_mm || 0;
    seeded = true;
  } catch(e){}
}
async function refreshExtensions(){
  try {
    const r = await (await fetch('/control', {method:'POST',
      body: JSON.stringify({command:'list_extensions'})})).json();
    if (!r.reply) return;
    const el = document.getElementById('extlist');
    el.innerHTML = '';
    for (const [name, active] of Object.entries(r.reply)){
      const d = document.createElement('div');
      d.innerHTML = (active?'[on] ':'[off] ') + name + ' ';
      const b = document.createElement('button');
      b.textContent = active ? 'deactivate' : 'activate';
      b.onclick = async () => { await post({command:
        (active?'deactivate':'activate')+'_extension', name: name});
        refreshExtensions(); };
      d.appendChild(b); el.appendChild(d);
      if (active) showExtensionOutput(name);
    }
  } catch(e){}
}
function fmtNum(v){
  if (typeof v !== 'number') return String(v);
  return Number.isInteger(v) ? String(v) : v.toFixed(4);
}
// generic extension pane renderer (ExtensionUIManager analog): ANY active
// extension's get_output() shapes — scalars / series / table / image /
// text — get a pane with zero viewer edits
async function showExtensionOutput(name){
  try {
    const r = await (await fetch('/extension.json?name=' + name)).json();
    let pane = document.getElementById('pane_' + name);
    if (!pane){
      pane = document.createElement('div');
      pane.id = 'pane_' + name; pane.style.margin = '6px 0';
      document.getElementById('extpanes').appendChild(pane);
    }
    pane.innerHTML = '';
    const head = document.createElement('b');
    head.textContent = name + '  ';
    pane.appendChild(head);
    if (r.error){
      const e = document.createElement('span');
      e.style.color = '#f88'; e.textContent = r.error;
      pane.appendChild(e);
    }
    if (r.scalars){
      const t = document.createElement('span');
      t.textContent = Object.entries(r.scalars)
        .map(([k, v]) => k + '=' + fmtNum(v)).join('  ');
      pane.appendChild(t);
    }
    if (r.text){
      const p = document.createElement('pre');
      p.textContent = r.text; pane.appendChild(p);
    }
    if (r.table && r.table.length){
      const keys = Object.keys(r.table[0]);
      const p = document.createElement('pre');
      p.textContent = [keys.join('  ')].concat(r.table.map(row =>
        keys.map(k => fmtNum(row[k])).join('  '))).join('\\n');
      pane.appendChild(p);
    }
    for (const [sname, arr] of Object.entries(r.series || {})){
      if (!Array.isArray(arr) || !arr.length) continue;
      const c = document.createElement('canvas');
      c.width = 420; c.height = 100; pane.appendChild(c);
      const g = c.getContext('2d');
      // reduce, not spread: Math.max(...arr) throws RangeError past the
      // engine's argument-count limit (~65k) on long series
      const mx = arr.reduce((a, b) => b > a ? b : a, -Infinity);
      const mn = Math.min(arr.reduce((a, b) => b < a ? b : a, Infinity), 0);
      const w = c.width / arr.length;
      g.fillStyle = '#4a8';
      arr.forEach((h, i) => {
        const hh = (h - mn) / ((mx - mn) || 1) * (c.height - 14);
        g.fillRect(i*w, c.height - hh, Math.max(w - 1, 1), hh);
      });
      g.fillStyle = '#9ab'; g.font = '10px monospace';
      g.fillText(sname + '  [' + fmtNum(mn) + ', ' + fmtNum(mx) + ']', 4, 10);
    }
    if (r.image && r.image.length){
      const h = r.image.length, w = r.image[0].length;
      const c = document.createElement('canvas');
      c.width = w; c.height = h; c.style.width = '210px';
      pane.appendChild(c);
      const g = c.getContext('2d'), im = g.createImageData(w, h);
      for (let y = 0; y < h; y++) for (let x = 0; x < w; x++){
        const v = Math.max(0, Math.min(1, r.image[y][x])) * 255;
        const o = 4*(y*w + x);
        im.data[o] = im.data[o+1] = im.data[o+2] = v; im.data[o+3] = 255;
      }
      g.putImageData(im, 0, 0);
    }
  } catch(e){}
}
async function tick(){
  const t = Date.now();
  document.getElementById('bscan').src = '/bscan.png?' + t;
  document.getElementById('enface').src = '/enface.png?' + t;
  if (!seeded) seed();
  if (t % 2000 < 300) refreshExtensions();
  try {
    const s = await (await fetch('/stats.json')).json();
    document.getElementById('stats').textContent = s.info || JSON.stringify(s);
    if (s.volume_renders){
      document.getElementById('volPane').style.display = '';
      if (!vstate.seeded) seedRender();
      // don't fight an in-progress drag for the pane image
      if (!vstate.posting)
        document.getElementById('volume').src = '/volume.png?' + t;
    }
    if (s.camera){
      const c = document.getElementById('camera');
      c.style.display = ''; c.src = '/camera.png?' + t;
    }
    if (s.recording != null) document.getElementById('recstate').textContent =
      s.recording ? 'REC' : '';
    const a = await (await fetch('/ascan.json')).json();
    const c = document.getElementById('ascan'), g = c.getContext('2d');
    g.clearRect(0,0,c.width,c.height); g.strokeStyle='#6cf'; g.beginPath();
    const v = a.values || [];
    for (let i = 0; i < v.length; i++) {
      const x = i / Math.max(1, v.length - 1) * c.width;
      const y = c.height - Math.min(1, Math.max(0, v[i])) * c.height;
      i ? g.lineTo(x, y) : g.moveTo(x, y);
    }
    g.stroke();
  } catch (e) {}
}
setInterval(tick, 250); tick();
</script></body></html>"""


def _jsonable(obj):
    """Dataclass / numpy / dict / scalar -> JSON-serializable structure.

    Recurses into dicts too: a get_output() returning numpy values nested
    under 'scalars'/'series' (the natural product of numpy analysis) must
    serialize, not 500 the pane."""
    import dataclasses as _dc

    if _dc.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _jsonable(v) for k, v in _dc.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        # EVERY numpy scalar — np.bool_ is neither np.integer nor
        # np.floating and json.dumps rejects it
        return obj.item()
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)  # last resort: never hand json.dumps a live object


def _compose(frames: np.ndarray, mip: bool) -> np.ndarray:
    """Averaging / maximum-intensity composite over adjacent frames
    (DISPLAY_FUNCTION semantics, octalgorithmparameters.h:176-179)."""
    return frames.max(axis=0) if mip else frames.mean(axis=0)


class LiveView:
    """Live state holder + HTTP server.

    Wire it to a :class:`~octproz_tpu_torch.runtime.StreamingEngine` via
    ``engine.on_processed = live.update`` and
    ``engine.on_metrics = live.update_stats`` (or use :meth:`attach`).

    ``device``: where the volume raycast runs; :meth:`attach` replaces it
    with the engine's model's device.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 lut: str = "gray", bscan_nr: int = 0, enface_depth: int = 0,
                 display_frames: int = 1, mip: bool = False,
                 throttle_s: float = 0.08, controller=None,
                 volume_render: bool = False, volume_throttle_s: float = 1.0,
                 volume_size: int = 224, volume_mode: str = "mip",
                 device="cuda"):
        self._lock = threading.Lock()
        self.device = torch.device(device)
        self._stream = None  # the viewer's own CUDA stream, drawn at first render
        self._lut = builtin_lut(lut) if lut != "gray" else None
        self.bscan_nr = bscan_nr
        self.enface_depth = enface_depth
        self.display_frames = display_frames
        self.mip = mip
        self.throttle_s = throttle_s
        self._last_render = 0.0
        self._bscan_png: Optional[bytes] = None
        self._enface_png: Optional[bytes] = None
        self._volume_png: Optional[bytes] = None
        self._ascan: list = []
        self._stats: dict = {}
        # displayed-orientation grayscale frames for the data cursor
        # (/pixel) — the GLWindow2D cursor readout analog
        self._frames: dict = {}
        # physical scale for the client-side scale bars (ScaleBar analog,
        # glwindow2d.cpp:520-1037); 0 = unset
        self.depth_mm = 0.0
        self.width_mm = 0.0
        self._engine = None
        self.frames_rendered = 0
        # live re-tuning (ParamController; POST /control)
        self._controller = controller
        # live 3D view of the assembled volume (cuda_code.cu:914-941 analog),
        # throttled much harder than the 2-D frames (a full raycast per tick)
        self.volume_render = volume_render
        self.volume_throttle_s = volume_throttle_s
        self.volume_size = volume_size
        self.volume_mode = volume_mode
        self._assembler = None
        self._last_volume_render = 0.0
        self.volume_renders = 0
        # wall time of the last raycast (host clock: the volume's copy to
        # the device, the ray march, the image's copy back)
        self.last_render_ms: Optional[float] = None
        # interactive 3-D view state (trackball + per-frame mode uniforms,
        # glwindow3d.cpp:266-272,300-360 + controlpanel.h:67-84), driven by
        # POST /render and drag-to-rotate on the volume pane
        self._render_state = {"mode": volume_mode, "yaw": 0.5, "pitch": 0.4,
                              "threshold": 0.25, "gamma": 2.0,
                              "step_length": 0.02, "lut": lut}
        # LUT array computed ONCE per selection (set_render), not per
        # raycast — the render path runs every throttle tick and drag
        self._volume_lut = (builtin_lut(lut) if lut and lut != "gray"
                            else None)
        self._render_lock = threading.Lock()
        # optional sample-view camera pane (/camera.png)
        self._camera = None

        view = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    body, ctype = _PAGE.encode(), "text/html"
                elif path == "/bscan.png":
                    body, ctype = view._bscan_png or b"", "image/png"
                elif path == "/enface.png":
                    body, ctype = view._enface_png or b"", "image/png"
                elif path == "/volume.png":
                    body, ctype = view._volume_png or b"", "image/png"
                elif path == "/camera.png":
                    # sample-view video pane (CameraExtension analog of the
                    # reference's Camera plugin, docs/docs/plugins.md:22-24)
                    frame = (view._camera.current_frame()
                             if view._camera is not None else None)
                    if frame is None:
                        self.send_error(404)
                        return
                    body, ctype = encode_png(frame), "image/png"
                elif path == "/ascan.json":
                    body = json.dumps({"values": view._ascan}).encode()
                    ctype = "application/json"
                elif path == "/stats.json":
                    with view._lock:
                        body = json.dumps(dict(
                            view._stats,
                            camera=view._camera is not None,
                            recording=getattr(view._engine, "recording",
                                              None))).encode()
                    ctype = "application/json"
                elif path == "/params.json":
                    c = view._controller
                    body = json.dumps(c.describe() if c else {}).encode()
                    ctype = "application/json"
                elif path == "/display.json":
                    body = json.dumps(view.display_state()).encode()
                    ctype = "application/json"
                elif path == "/render.json":
                    body = json.dumps(view.render_state()).encode()
                    ctype = "application/json"
                elif path == "/pixel":
                    # data-cursor readout: value of a displayed pixel
                    body = json.dumps(view.pixel_value(self.path)).encode()
                    ctype = "application/json"
                elif path == "/extension.json":
                    out = view.extension_output(self.path)
                    if out is None:
                        self.send_error(404)
                        return
                    body, ctype = json.dumps(out).encode(), "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                path = self.path.split("?")[0]
                if path not in ("/control", "/display", "/render"):
                    self.send_error(404)
                    return
                if path == "/control" and view._controller is None:
                    self.send_error(403, "no controller attached")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    msg = json.loads(self.rfile.read(n).decode())
                    if not isinstance(msg, dict):
                        raise ValueError("body must be a json object")
                    if path == "/display":
                        reply = view.set_display(msg)
                    elif path == "/render":
                        reply = view.set_render(msg)
                    else:
                        cmd = msg.pop("command", None)
                        reply = view._controller.handle(cmd, msg)
                except (KeyError, TypeError, ValueError,
                        UnicodeDecodeError) as e:
                    reply = {"error": f"bad request: {e}"}
                body = json.dumps(reply).encode()
                self.send_response(200 if "error" not in reply else 400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="octproz-liveview")
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/"

    # -- engine hooks --------------------------------------------------------
    def attach(self, engine, controller=None) -> None:
        """Chain onto an engine's callbacks (keeps any existing ones).

        ``controller``: a :class:`~octproz_tpu_torch.control.ParamController`
        enabling POST /control live re-tuning.  With ``volume_render`` the
        engine grows a :class:`VolumeAssembler` (if it has none) and the
        assembled stream is raycast into /volume.png periodically — the
        reference's per-buffer volume-texture update + throttled redraw
        (cuda_code.cu:914-941, glwindow3d.h:84).  The raycast moves to the
        engine's model's device."""
        if getattr(engine, "model", None) is not None:
            self.device = engine.model.device
        if controller is not None:
            self._controller = controller
        elif self._controller is None and getattr(engine, "model", None) is not None:
            from ..control import ParamController

            self._controller = ParamController(engine.model, engine,
                                               on_info=engine.on_info)
        if self.volume_render:
            if engine.assembler is None:
                from ..io.volume import VolumeAssembler

                engine.assembler = VolumeAssembler(engine.model.acq)
            self._assembler = engine.assembler
        self._engine = engine
        self._bit_depth = getattr(engine, "streaming_bit_depth", None)
        prev_p, prev_m = engine.on_processed, engine.on_metrics

        def on_processed(vol, nr):
            if prev_p:
                prev_p(vol, nr)
            self.update(vol, nr)

        def on_metrics(stats):
            if prev_m:
                prev_m(stats)
            self.update_stats(stats)

        engine.on_processed = on_processed
        engine.on_metrics = on_metrics

    def attach_camera(self, camera) -> None:
        """Serve a CameraExtension's frames at /camera.png (the reference's
        Camera plugin video pane, docs/docs/plugins.md:22-24)."""
        self._camera = camera

    def update(self, volume: np.ndarray, buffer_nr: int = 0) -> None:
        """Render the latest processed buffer (throttled).

        volume: float (bscans, ascans, depth) 0..1, or a quantized uint
        buffer (converted).  Called from the engine loop thread.
        """
        now = time.monotonic()
        if now - self._last_render < self.throttle_s:
            return
        self._last_render = now

        vol = np.asarray(volume)

        def normalized(part):
            """The displayed slices alone, as float 0..1: an elementwise
            normalization, so slicing first gives the same numbers."""
            if not np.issubdtype(part.dtype, np.integer):
                return part
            # normalize by the quantized CODE max (attach() recorded the
            # engine's streaming bit depth; 12-bit codes ride in uint16)
            from ..ops.quantize import dequantize

            bits = getattr(self, "_bit_depth", None)
            return (dequantize(part, bits) if bits else
                    part.astype(np.float32) / float(np.iinfo(part.dtype).max))

        n_b = vol.shape[0]
        b0 = min(max(self.bscan_nr, 0), n_b - 1)
        b1 = min(b0 + max(self.display_frames, 1), n_b)
        bscan = _compose(normalized(vol[b0:b1]), self.mip)   # (ascans, depth)
        d0 = min(max(self.enface_depth, 0), vol.shape[2] - 1)
        d1 = min(d0 + max(self.display_frames, 1), vol.shape[2])
        enface = _compose(np.moveaxis(normalized(vol[:, :, d0:d1]), 2, 0), self.mip)

        def paint(img, vertical):
            if vertical:  # depth axis vertical, reference B-scan orientation
                img = img.T[::-1]
            gray = np.clip(img, 0.0, 1.0)
            img = gray
            if self._lut is not None:
                img = apply_lut(img, self._lut)
            return gray, encode_png(to_uint8(img))

        bscan_gray, bscan_png = paint(bscan, True)
        enface_gray, enface_png = paint(enface, False)
        ascan = [float(x) for x in bscan[bscan.shape[0] // 2]]

        volume_png = None
        if (self._assembler is not None
                and now - self._last_volume_render >= self.volume_throttle_s):
            self._last_volume_render = now
            # block=False: this runs on the ENGINE loop thread — if an HTTP
            # /render raycast is in flight, skip this refresh rather than
            # stall the stream behind it (the next throttle tick retries)
            volume_png = self._render_assembled_volume(block=False)

        with self._lock:
            self._bscan_png, self._enface_png = bscan_png, enface_png
            self._frames = {"bscan": bscan_gray, "enface": enface_gray}
            self._ascan = ascan
            self.frames_rendered += 1
            self._stats["buffers"] = self._stats.get("buffers", 0) + 1
            if volume_png is not None:
                self._volume_png = volume_png
                self.volume_renders += 1
                self._stats["volume_renders"] = self.volume_renders

    def _render_assembled_volume(self, block: bool = True) -> Optional[bytes]:
        """Raycast the assembler's current (possibly partial) volume —
        updateDisplayedVolume + 80 ms-throttled redraw analog
        (cuda_code.cu:914-941, glwindow3d.cpp:316-323) — under the LIVE
        view state (trackball yaw/pitch + per-frame mode uniforms,
        glwindow3d.cpp:300-360).  Runs on :attr:`device`, on the viewer's
        own stream there.  ``block=False`` (the engine-loop caller) skips the
        render when an interactive raycast already holds the lock."""
        from .render import RenderMode, RenderParams, render_volume

        if not self._render_lock.acquire(blocking=block):
            return None
        try:
            with self._lock:
                st = dict(self._render_state)
                lut = self._volume_lut
            if self.device.type == "cuda" and self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            t0 = time.perf_counter()
            img = render_volume(
                self._assembler.volume,
                RenderParams(mode=RenderMode(st["mode"]),
                             step_length=float(st["step_length"]),
                             threshold=float(st["threshold"]),
                             gamma=float(st["gamma"])),
                yaw=float(st["yaw"]), pitch=float(st["pitch"]),
                out_shape=(self.volume_size, self.volume_size),
                lut=lut,
                device=self.device, stream=self._stream)
            self.last_render_ms = (time.perf_counter() - t0) * 1e3
            return encode_png(to_uint8(np.clip(img, 0.0, 1.0)))
        finally:
            self._render_lock.release()

    def render_state(self) -> dict:
        from .render import RenderMode

        with self._lock:
            st = dict(self._render_state)
        st["modes"] = [m.value for m in RenderMode]
        st["renders"] = self.volume_renders
        return st

    def set_render(self, msg: dict) -> dict:
        """POST /render {mode, yaw, pitch, threshold, gamma, step_length,
        lut}: the live 3-D control surface (ControlPanel3D + trackball
        analog, controlpanel.h:67-84, glwindow3d.cpp:266-272).  Re-renders
        immediately from the current assembled volume so interaction is
        responsive between buffer arrivals."""
        from .render import RenderMode

        updates = {}
        lut_array = sentinel = object()
        if "mode" in msg:
            updates["mode"] = RenderMode(str(msg["mode"])).value
        if "lut" in msg:
            lut = msg["lut"] or None
            # validate loudly AND compute once here — the raycast path
            # reuses the cached array every frame
            lut_array = (builtin_lut(lut) if lut and lut != "gray"
                         else None)
            updates["lut"] = lut
        for key in ("yaw", "pitch", "threshold", "gamma", "step_length"):
            if key in msg:
                updates[key] = float(msg[key])
        if "step_length" in updates:
            # a tiny step length makes the raycast arbitrarily slow; clamp
            # to something interactive
            updates["step_length"] = min(max(updates["step_length"], 0.004),
                                         0.2)
        with self._lock:
            self._render_state.update(updates)
            if lut_array is not sentinel:
                self._volume_lut = lut_array
        if self._assembler is not None:
            png = self._render_assembled_volume()
            if png is not None:
                with self._lock:
                    self._volume_png = png
                    self.volume_renders += 1
                    self._stats["volume_renders"] = self.volume_renders
        return {"reply": self.render_state()}

    # -- display manipulation + data-cursor surface (GLWindow2D analog:
    #    frame selection ControlPanel2D, cursor readout, scale-bar physical
    #    scale; glwindow2d.cpp:520-1037, glwindow2d.h:186-200) -------------
    def display_state(self) -> dict:
        return {"bscan_nr": self.bscan_nr,
                "enface_depth": self.enface_depth,
                "frames": self.display_frames,
                "mip": self.mip,
                "depth_mm": self.depth_mm,
                "width_mm": self.width_mm}

    def set_display(self, msg: dict) -> dict:
        """POST /display: displayFrameSettingsChanged analog
        (glwindow2d.h:361) plus physical-scale settings for the scale bar."""
        if "bscan_nr" in msg:
            self.bscan_nr = int(msg["bscan_nr"])
        if "enface_depth" in msg:
            self.enface_depth = int(msg["enface_depth"])
        if "frames" in msg:
            self.display_frames = max(1, int(msg["frames"]))
        if "mip" in msg:
            self.mip = bool(msg["mip"])
        if "depth_mm" in msg:
            self.depth_mm = float(msg["depth_mm"])
        if "width_mm" in msg:
            self.width_mm = float(msg["width_mm"])
        return {"reply": self.display_state()}

    def pixel_value(self, path: str) -> dict:
        """GET /pixel?img=bscan|enface&x=..&y=.. — the data-cursor value of
        a displayed pixel (displayed orientation, pre-LUT grayscale)."""
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(path).query)
        img = q.get("img", ["bscan"])[0]
        with self._lock:
            frame = self._frames.get(img)
        try:
            x = int(q.get("x", ["0"])[0])
            y = int(q.get("y", ["0"])[0])
        except ValueError:
            return {"value": None}
        if frame is None or not (0 <= y < frame.shape[0]
                                 and 0 <= x < frame.shape[1]):
            return {"value": None}
        return {"value": float(frame[y, x]), "img": img, "x": x, "y": y}

    def extension_output(self, path: str):
        """GET /extension.json?name=... — the latest result of an active
        extension through the generic ``Extension.get_output()`` protocol
        (the headless ``ExtensionUIManager`` analog, extensionuimanager.cpp
        + extension.h:40-43): ANY extension that implements get_output gets
        a viewer pane with zero viewer edits; extensions predating the
        protocol fall back to attr sniffing classified into the same
        scalars/series/table shapes."""
        from urllib.parse import parse_qs, urlparse

        if self._engine is None:
            return None
        q = parse_qs(urlparse(path).query)
        name = q.get("name", [""])[0]
        ext = self._engine.extensions.extensions.get(name)
        if ext is None:
            return None
        out = {"name": name, "active": ext.active}
        result = None
        get = getattr(ext, "get_output", None)
        if callable(get):
            try:
                result = get()
                if result is not None and not isinstance(result, dict):
                    raise TypeError(
                        f"get_output must return a dict, got "
                        f"{type(result).__name__}")
            except Exception as e:  # a broken pane must not 500 the viewer
                out["error"] = f"get_output failed: {e}"
                result = None
        if result is None and "error" not in out:
            result = self._legacy_output(ext)
        for k, v in (result or {}).items():
            if k in ("name", "active", "error"):
                # reserved pane metadata — an extension's own status field
                # must not masquerade as a viewer-level failure/state
                k = f"ext_{k}"
            out[k] = _jsonable(v)
        return out

    @staticmethod
    def _legacy_output(ext):
        """Classify last / last_peaks / last_fit attributes of extensions
        without get_output into the generic output shapes."""
        scalars, series, table = {}, {}, None
        for attr in ("last", "last_peaks", "last_fit"):
            val = getattr(ext, attr, None)
            if val is None:
                continue
            if isinstance(val, list):
                table = [_jsonable(p) for p in val]
                continue
            d = _jsonable(val)
            if isinstance(d, dict):
                for k, v in d.items():
                    if isinstance(v, list):
                        series[k] = v
                    elif isinstance(v, (int, float, str, bool)):
                        scalars[k] = v
            elif isinstance(d, (int, float, str, bool)):
                scalars[attr] = d
        out = {}
        if scalars:
            out["scalars"] = scalars
        if series:
            out["series"] = series
        if table is not None:
            out["table"] = table
        return out or None

    def update_stats(self, stats) -> None:
        with self._lock:
            # merge, don't replace: update() maintains its own keys here
            # ("buffers", "volume_renders" — the page JS gates the volume
            # pane refresh on the latter)
            self._stats.update({
                "info": stats.info_line(),
                "ascans_per_s": stats.ascans_per_s,
                "bscans_per_s": stats.bscans_per_s,
                "buffers_per_s": stats.buffers_per_s,
                "volumes_per_s": stats.volumes_per_s,
                "mb_per_s": stats.mb_per_s,
                "buffers_processed": stats.buffers_processed,
            })

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
