"""The control-plane's built-in web UI (the reference UI shell, headless).

Reproduces the surfaces of the reference kiosk page as one self-contained
HTML document served on the WS port:

- status bar: server version, machine, WS state + msg/s meter
  (reference: app/multi/index.html:46-55, app/multi/app.mjs:799-816);
- per-channel control panels with sliders + number inputs + per-key reset
  buttons for the §2.5 key space, using the reference UI ranges
  (app/multi/index.html:75-186: rate 0-2, semitones ±24, tonality
  2000-20000 Hz, formantBase 50-500 Hz, block 30-300 ms, overlap 2-8);
  every change sends ``{"type":"set",channel,key,value}`` over the WS —
  the reference app's outbound form (app/multi/app.mjs:537-616);
- a scope + spectrum canvas per channel fed by the ``analyze`` request
  (the servable form of the disabled reference Scope, app/Scope.mjs:
  362-428).
"""

from __future__ import annotations

import json

__all__ = ["render_page"]

# key, label, min, max, step, default  (reference ranges + kiosk defaults,
# app/multi/index.html:86-182 and app/multi/app.mjs:106-130)
_CONTROLS = [
    ("rate", "rate", 0.0, 2.0, 0.001, 0.001),
    ("semitones", "semitones", -24, 24, 1, 0),
    ("tonalityHz", "tonality Hz", 2000, 20000, 100, 16000),
    ("formantSemitones", "formant st", -12, 12, 1, 0),
    ("formantBaseHz", "formant base Hz", 50, 500, 5, 200),
    ("volumePercent", "volume %", 0, 100, 1, 10),
    ("pan", "pan", -1.0, 1.0, 0.01, 0.0),
    ("blockMs", "block ms", 30, 300, 5, 120),
    ("overlap", "overlap", 1, 8, 0.5, 4),
]

_CSS = """
body{font:14px monospace;background:#111;color:#ddd;margin:0;padding:1.2em}
#bar{display:flex;gap:1.5em;align-items:center;border-bottom:1px solid #333;
  padding-bottom:.6em;margin-bottom:1em;flex-wrap:wrap}
.badge{padding:.1em .5em;border-radius:3px;background:#522}
.badge.ok{background:#252}
.ch{border:1px solid #333;border-radius:6px;padding:.8em 1em;margin:.8em 0;
  max-width:46em}
.ch h3{margin:.1em 0 .5em}
.row{display:flex;gap:.6em;align-items:center;margin:.15em 0}
.row label{width:10em;color:#9a9}
.row input[type=range]{flex:1}
.row input[type=number]{width:6em;background:#222;color:#ddd;border:1px solid
  #444}
.row button{background:#333;color:#bbb;border:1px solid #555;cursor:pointer}
.row .chk{flex:1}
canvas{background:#000;border:1px solid #333;display:block;margin-top:.5em}
pre{color:#888;max-width:60em;white-space:pre-wrap}
"""

_JS = """
const slots = SLOTS;
const controls = CONTROLS;
let msgs = 0, ws = null;
const $ = id => document.getElementById(id);

function send(channel, key, value){
  if (ws && ws.readyState === 1)
    ws.send(JSON.stringify({type:'set', channel, key, value}));
}
function buildPanels(){
  const root = $('channels');
  for (const slot of slots){
    const div = document.createElement('div');
    div.className = 'ch';
    let h = `<h3>channel ${slot}</h3>`;
    for (const [key, label, min, max, step, dflt] of controls){
      h += `<div class=row><label>${label}</label>
        <input type=range id="r-${slot}-${key}" min=${min} max=${max}
          step=${step} value=${dflt}>
        <input type=number id="n-${slot}-${key}" min=${min} max=${max}
          step=${step} value=${dflt}>
        <button id="x-${slot}-${key}" title=reset>&#8634;</button></div>`;
    }
    h += `<div class=row><label>formant comp.</label>
      <span class=chk><input type=checkbox id="c-${slot}-fc"></span></div>`;
    h += `<div class=row><label>playback</label>
      <input type=range id="p-${slot}" min=0 max=30 step=0.01 value=0>
      <span id="pt-${slot}">0.00 s</span></div>`;
    h += `<canvas id="scope-${slot}" width=420 height=70></canvas>`;
    h += `<canvas id="spec-${slot}" width=420 height=70></canvas>`;
    h += `<canvas id="hist-${slot}" width=420 height=48></canvas>`;
    h += `<canvas id="sg-${slot}" width=420 height=70></canvas>`;
    div.innerHTML = h;
    root.appendChild(div);
    for (const [key,,min,max,step,dflt] of controls){
      const r = $(`r-${slot}-${key}`), n = $(`n-${slot}-${key}`);
      const push = v => { r.value = v; n.value = v; send(slot, key, +v); };
      r.oninput = () => push(r.value);
      n.onchange = () => push(n.value);
      $(`x-${slot}-${key}`).onclick = () => push(dflt);
    }
    $(`c-${slot}-fc`).onchange =
      e => send(slot, 'formantCompensation', e.target.checked);
    // drag-to-seek, like the reference playback slider
    // (app/multi/app.mjs:735-737: drag schedules {input: v})
    const p = $(`p-${slot}`);
    p.onchange = () => send(slot, 'input', +p.value);
  }
}
function drawScope(slot, scope){
  const c = $(`scope-${slot}`); if (!c) return;
  const g = c.getContext('2d'); g.clearRect(0,0,c.width,c.height);
  g.strokeStyle = '#4c4'; g.beginPath();
  const n = scope.length;
  for (let i=0;i<n;i++){
    const x = i/(n-1)*c.width;
    const ylo = c.height/2*(1-scope[i][0]), yhi = c.height/2*(1-scope[i][1]);
    g.moveTo(x, ylo); g.lineTo(x, yhi);
  }
  g.stroke();
}
function drawSpec(slot, spec){
  const c = $(`spec-${slot}`); if (!c) return;
  const g = c.getContext('2d'); g.clearRect(0,0,c.width,c.height);
  g.fillStyle = '#39f';
  const n = spec.length, w = c.width/n;
  for (let i=0;i<n;i++){
    const h = Math.max(0, (spec[i]+90)/90)*c.height;
    g.fillRect(i*w, c.height-h, Math.max(1,w-0.5), h);
  }
}
function drawHistory(slot, scope, spec){
  // scrolling history strips, like the reference Scope's retained
  // waveform/spectrogram history (app/Scope.mjs:440-610): shift the
  // canvas left and append one column per analysis frame
  const hc = $(`hist-${slot}`);
  if (hc){
    const g = hc.getContext('2d');
    g.drawImage(hc, -2, 0);
    g.fillStyle = '#000'; g.fillRect(hc.width-2, 0, 2, hc.height);
    let lo = 1, hi = -1;
    for (const [a, b] of scope){ lo = Math.min(lo, a); hi = Math.max(hi, b); }
    const ylo = hc.height/2*(1-lo), yhi = hc.height/2*(1-hi);
    g.strokeStyle = '#4c4'; g.beginPath();
    g.moveTo(hc.width-1, ylo); g.lineTo(hc.width-1, yhi); g.stroke();
  }
  const sc = $(`sg-${slot}`);
  if (sc){
    const g = sc.getContext('2d');
    g.drawImage(sc, -2, 0);
    const n = spec.length;
    for (let i=0;i<n;i++){
      const v = Math.max(0, Math.min(1, (spec[i]+90)/90));
      g.fillStyle = `rgb(${Math.round(16+v*48)},${Math.round(16+v*96)},${
        Math.round(32+v*223)})`;
      const y = sc.height - (i+1)/n*sc.height;
      g.fillRect(sc.width-2, y, 2, sc.height/n + 1);
    }
  }
}
function connect(){
  ws = new WebSocket(`ws://${location.host}`);
  ws.onopen = () => {
    $('wsb').textContent = 'ws: open'; $('wsb').className = 'badge ok';
    ws.send(JSON.stringify({type:'hello', engineSlots:slots}));
  };
  ws.onclose = () => {
    $('wsb').textContent = 'ws: closed'; $('wsb').className = 'badge';
    setTimeout(connect, 1000);   // 1 s reconnect (app/multi/app.mjs:838-843)
  };
  ws.onmessage = e => {
    msgs++;
    const m = JSON.parse(e.data);
    if (m.type === 'serverVersion') $('ver').textContent = 'v' + m.version;
    else if (m.type === 'machineStatus')
      $('mach').textContent = `${m.user}@${m.hostname}`;
    else if (m.type === 'controllerStatus')
      $('ctl').textContent = 'controller: ' +
        (m.connected ? (m.deviceId || 'yes') : 'none');
    else if (m.type === 'set'){
      const r = $(`r-${m.engine || m.channel}-${m.key}`);
      const n = $(`n-${m.engine || m.channel}-${m.key}`);
      if (r && document.activeElement !== r && document.activeElement !== n){
        r.value = m.value; n.value = m.value;
      }
    } else if (m.type === 'time'){
      // 5 Hz playback position (server time_status_task; reference
      // slider refresh app/multi/app.mjs:740-753)
      const p = $(`p-${m.slot}`), pt = $(`pt-${m.slot}`);
      if (p && document.activeElement !== p){
        if (+p.max < m.inputTime) p.max = Math.ceil(m.inputTime);
        p.value = m.inputTime;
      }
      if (pt) pt.textContent = m.inputTime.toFixed(2) + ' s';
    } else if (m.type === 'analysis' && m.scope){
      drawScope(m.slot, m.scope); drawSpec(m.slot, m.spectrum);
      drawHistory(m.slot, m.scope, m.spectrum);
    }
  };
}
setInterval(() => {                    // msg/s meter (app/multi/app.mjs:809)
  $('rate').textContent = msgs + ' msg/s'; msgs = 0;
}, 1000);
setInterval(() => {                    // scope/spectrum poll
  if (ws && ws.readyState === 1)
    for (const slot of slots) ws.send(JSON.stringify({type:'analyze', slot}));
}, 500);
async function tick(){
  const r = await fetch('/status');
  $('s').textContent = JSON.stringify(await r.json(), null, 2);
}
buildPanels(); connect(); tick(); setInterval(tick, 2000);
"""


def render_page(version: str, slots: list[str]) -> str:
    js = _JS.replace("SLOTS", json.dumps(slots)).replace(
        "CONTROLS", json.dumps([list(c) for c in _CONTROLS])
    )
    return (
        "<!doctype html><meta charset='utf-8'><title>bauklank</title>"
        f"<style>{_CSS}</style>"
        "<div id=bar>"
        "<b>bauklank control plane</b>"
        f"<span id=ver>v{version}</span>"
        "<span id=mach></span>"
        "<span id=wsb class=badge>ws: …</span>"
        "<span id=rate>0 msg/s</span>"
        "<span id=ctl>controller: …</span>"
        "</div>"
        "<div id=channels></div>"
        "<pre id=s>loading…</pre>"
        f"<script>{js}</script>"
    )
