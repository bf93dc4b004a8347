/* asciichat-tpu browser app: connection, settings UI, chat, audio duplex,
 * camera uplink, stats HUD, and a built-in render benchmark.
 *
 * Counterpart of the reference's web/ TypeScript app (served page + browser
 * client over the WebSocket transport). Rendering is parse-once-to-cells
 * (ansi.js) + canvas blit/diff (renderer.js) — NOT per-frame HTML.
 *
 * Syntax ceiling: Qt-V4-compatible ES6/ES7 ON PURPOSE — no async/await, no
 * object spread, and no `new Promise` on any driven path. Browser APIs that
 * return Promises are consumed via .then/.catch chains, which work equally
 * on real Promises and on the synchronous thenables the CI harness's
 * browser shims return (the only JS engine in CI, Qt5 QML V4 via
 * native/qjs.cpp, never drains promise reaction jobs: there is no event
 * loop inside one evaluate call). This is what lets the file EXECUTE in CI
 * (tests/test_webclient.py) instead of being audited by inspection —
 * matching the reference's executed-web-code discipline
 * (the reference's web/ test scripts; src/web/main_wasm.c:1-37).
 *
 * Bench modes (also used by tests/headless drivers):
 *   ?bench=local  render a synthetic 203x64 truecolor frame stream offline
 *                 (no server needed); results in #hud and window.__bench.
 *   live HUD      parse/draw times are measured continuously either way.
 */
"use strict";

const { AnsiGrid } = globalThis.AsciichatAnsi;
const { CanvasRenderer } = globalThis.AsciichatRenderer;
const A = globalThis.AsciichatAcip;

const $ = (id) => document.getElementById(id);
const dec = new TextDecoder();

// ---------------------------------------------------------------------------
// state

const FILTERS = ["none", "black", "white", "green", "magenta", "fuchsia",
  "orange", "teal", "cyan", "pink", "red", "yellow", "rainbow"];
const PALETTES = {
  standard: "   ...',;:clodxkO0KXNWM",
  blocks: "   ░░▒▒▓▓██",
  minimal: "   .-+*#",
  cool: "   ▁▂▃▄▅▆▇█",
};

const settings = {
  colorLevel: 3,     // 3=truecolor 2=256 1=16 0=mono
  renderMode: 2,     // 0=FG 1=BG 2=HALF_BLOCK
  palette: "standard",
  colorFilter: 0,
  desiredFps: 60,
  fontPx: 14,
  fitWindow: true,
  cols: 203,
  rows: 64,
};

const stats = {
  frames: 0, bytes: 0, parseMs: 0, drawMs: 0, t0: performance.now(),
  netFps: 0, renderPath: "",
};

let grid = new AnsiGrid(256, 128);
let renderer = null;
let ws = null;
let wsState = "idle";
let backoffMs = 250;
let intentionalClose = false;
let pingTimer = null;
// "ws" (default) or "webrtc" (?transport=webrtc): DataChannel with
// automatic permanent fallback to the WebSocket when signaling fails
let transportPref = "ws";

// ---------------------------------------------------------------------------
// rendering + stats

function handleFrame(payload) {
  const f = A.parseAsciiFrame(payload);
  if (f.compressedSize > 0) return; // we advertise the no-zstd bit
  const t0 = performance.now();
  const text = dec.decode(f.body);
  grid.parse(text);
  const t1 = performance.now();
  stats.renderPath = renderer.draw(grid);
  const t2 = performance.now();
  stats.frames++;
  stats.bytes += payload.length;
  stats.parseMs = 0.9 * stats.parseMs + 0.1 * (t1 - t0);
  stats.drawMs = 0.9 * stats.drawMs + 0.1 * (t2 - t1);
  const dt = (t2 - stats.t0) / 1000;
  if (dt >= 1) {
    stats.netFps = stats.frames / dt;
    stats.kbps = stats.bytes / dt / 1024;
    stats.frames = 0;
    stats.bytes = 0;
    stats.t0 = t2;
    updateHud();
  }
}

function updateHud() {
  const renderMs = stats.parseMs + stats.drawMs;
  const headroom = renderMs > 0 ? 1000 / renderMs : 0;
  $("hud").textContent =
    `${stats.netFps.toFixed(1)} fps net | parse ${stats.parseMs.toFixed(2)}ms ` +
    `draw ${stats.drawMs.toFixed(2)}ms (${stats.renderPath}) -> ` +
    `${headroom.toFixed(0)} fps render capacity | ${grid.w}x${grid.h} | ` +
    `${(stats.kbps || 0).toFixed(0)} kB/s | ${stats.transport || "ws"}`;
  window.__stats = Object.assign({}, stats,
    { gridW: grid.w, gridH: grid.h, headroom: headroom });
}

// ---------------------------------------------------------------------------
// sizing

function computeGridSize() {
  if (!settings.fitWindow) return { cols: settings.cols, rows: settings.rows };
  const avail = $("stage");
  const cols = Math.max(20, Math.floor(avail.clientWidth / renderer.cellW));
  const rows = Math.max(10, Math.floor(avail.clientHeight / renderer.cellH));
  return { cols: cols, rows: rows };
}

function sendCaps() {
  if (!ws || ws.readyState !== 1) return;
  const size = computeGridSize();
  settings.cols = size.cols;
  settings.rows = size.rows;
  ws.send(A.packPacket(A.T.CLIENT_CAPABILITIES, A.capsPayload({
    cols: size.cols, rows: size.rows,
    colorLevel: settings.colorLevel,
    renderMode: settings.renderMode,
    paletteCustom: settings.palette === "standard" ? "" : PALETTES[settings.palette],
    desiredFps: settings.desiredFps,
    colorFilter: settings.colorFilter,
  })));
}

let resizeTimer = null;
window.addEventListener("resize", () => {
  clearTimeout(resizeTimer);
  resizeTimer = setTimeout(() => {
    if (!ws || ws.readyState !== 1) return;
    const size = computeGridSize();
    ws.send(A.packPacket(A.T.SIZE_MESSAGE, A.sizePayload(size.cols, size.rows)));
  }, 250);
});

// ---------------------------------------------------------------------------
// connection (with reconnect/backoff — src/client/keepalive.c role)

function setStatus(text, cls) {
  const el = $("status");
  el.textContent = text;
  el.className = cls || "";
}

function connect() {
  intentionalClose = false;
  setStatus("connecting…", "warn");
  if (transportPref === "webrtc" && window.RTCPeerConnection) {
    connectWebRtc();
    return;
  }
  const w = new WebSocket(`ws://${location.host}/ws`);
  w.binaryType = "arraybuffer";
  wireTransport(w, "ws");
}

/* A thenable that resolves when ICE gathering completes (or 2 s pass).
 * Deliberately NOT `new Promise`: returning a plain thenable keeps the
 * chain synchronous under the CI engine while assimilating identically
 * into the real-browser Promise chain. */
function iceGatheringDone(pc) {
  return { then: function (res) {
    if (pc.iceGatheringState === "complete") { res(); return; }
    let fired = false;
    const fire = () => { if (!fired) { fired = true; res(); } };
    pc.onicegatheringstatechange = () => {
      if (pc.iceGatheringState === "complete") fire();
    };
    setTimeout(fire, 2000);
  } };
}

/* WebRTC DataChannel transport (?transport=webrtc): the browser-native
 * ICE+DTLS+SCTP stack against the server's /webrtc/offer signaling endpoint
 * (net/{dtls,sctp,datachannel}.py + apps/webclient.WebRtcGateway). The
 * DataChannel carries the SAME ACIP binary packets as the WebSocket, so
 * everything above the transport is shared; a wrapper gives it the
 * WebSocket surface (numeric readyState, onmessage/onopen/onclose). */
function connectWebRtc() {
  const pc = new RTCPeerConnection();
  const dc = pc.createDataChannel("acip");
  dc.binaryType = "arraybuffer";
  const shim = {
    readyState: 0,
    send: (buf) => dc.send(buf),
    close: () => { shim.readyState = 3; try { dc.close(); } catch (e) {} pc.close(); },
    onopen: null, onclose: null, onerror: null, onmessage: null,
  };
  dc.onopen = () => { shim.readyState = 1; if (shim.onopen) shim.onopen(); };
  dc.onclose = () => {
    if (shim.readyState === 3) return;
    shim.readyState = 3;
    if (shim.onclose) shim.onclose();
  };
  dc.onmessage = (ev) => { if (shim.onmessage) shim.onmessage(ev); };
  wireTransport(shim, "webrtc");
  const fail = (e) => {
    // signaling or stack failure: permanent fallback to the WebSocket.
    // Detach the shim's handlers FIRST — pc.close() fires dc teardown
    // asynchronously, and the wired onclose would otherwise clear the new
    // WebSocket's keepalive timer and schedule a SECOND connect()
    shim.onopen = shim.onclose = shim.onmessage = null;
    shim.readyState = 3;
    setStatus("webrtc unavailable; using websocket", "warn");
    transportPref = "ws";
    try { pc.close(); } catch (e2) {}
    if (!intentionalClose) connect();
  };
  pc.createOffer()
    .then((offer) => pc.setLocalDescription(offer))
    .then(() => iceGatheringDone(pc)) // non-trickle: wait for gathering
    .then(() => fetch("/webrtc/offer", {
      method: "POST",
      headers: { "Content-Type": "application/sdp" },
      body: pc.localDescription.sdp,
    }))
    .then((resp) => {
      if (!resp.ok) throw new Error(`signaling ${resp.status}`);
      return resp.text();
    })
    .then((sdp) => pc.setRemoteDescription({ type: "answer", sdp: sdp }))
    // dc.onopen fires once ICE+DTLS+SCTP+DCEP complete
    .catch(fail);
}

function wireTransport(w, kind) {
  ws = w;
  stats.transport = kind;
  ws.onopen = () => {
    wsState = "open";
    backoffMs = 250;
    setStatus("connected", "ok");
    sendCaps();
    // keepalive ping (src/client/keepalive.c role): the server sweeps
    // clients that go silent, and an idle viewer sends nothing else
    clearInterval(pingTimer);
    pingTimer = setInterval(() => {
      if (ws && ws.readyState === 1)
        ws.send(A.packPacket(A.T.PING, new TextEncoder().encode(String(Date.now()))));
    }, 5000);
  };
  ws.onclose = () => {
    wsState = "closed";
    clearInterval(pingTimer);
    if (intentionalClose) { setStatus("disconnected", ""); return; }
    setStatus(`reconnecting in ${(backoffMs / 1000).toFixed(1)}s…`, "warn");
    setTimeout(connect, backoffMs);
    backoffMs = Math.min(backoffMs * 2, 8000);
  };
  ws.onerror = () => {};
  ws.onmessage = (ev) => {
    // a text frame has no byteLength: `undefined < N` is false, so without
    // the type check it would reach new DataView(string) and throw out of
    // onmessage — same drop-don't-throw rule as the checks below
    if (!(ev.data instanceof ArrayBuffer)) return;
    if (ev.data.byteLength < A.HEADER_SIZE) return;
    const dv = new DataView(ev.data);
    // validate magic + declared length against the actual buffer: a
    // truncated/corrupt packet must be dropped, not throw out of onmessage
    if (dv.getUint32(0) !== 0x0000000a || dv.getUint32(4) !== 0x5c11c4a1) return;
    const hdr = A.unpackHeader(dv);
    const type = hdr.type, length = hdr.length;
    if (length > ev.data.byteLength - A.HEADER_SIZE) return;
    const payload = new Uint8Array(ev.data, A.HEADER_SIZE, length);
    if (type === A.T.ASCII_FRAME) handleFrame(payload);
    else if (type === A.T.AUDIO_BATCH) playAudioBatch(payload);
    else if (type === A.T.TEXT_MESSAGE) addChat(dec.decode(payload.subarray(0, 500)));
    else if (type === A.T.SERVER_STATE) {
      try {
        const st = JSON.parse(dec.decode(payload));
        $("roster").textContent =
          `${st.clients}/${st.max_clients} connected, ${st.streaming} streaming`;
      } catch (e) { /* ignore */ }
    } else if (type === A.T.PING) {
      ws.send(A.packPacket(A.T.PONG, payload));
    }
  };
}

// ---------------------------------------------------------------------------
// chat

function addChat(text) {
  const line = document.createElement("div");
  line.textContent = "> " + text;
  const chat = $("chat");
  chat.appendChild(line);
  while (chat.childNodes.length > 50) chat.removeChild(chat.firstChild);
  chat.scrollTop = chat.scrollHeight;
}

function sendChat() {
  const msgEl = $("msg");
  if (!msgEl.value || !ws || ws.readyState !== 1) return;
  ws.send(A.packPacket(A.T.TEXT_MESSAGE,
    new TextEncoder().encode(msgEl.value.slice(0, 500))));
  msgEl.value = "";
}

// ---------------------------------------------------------------------------
// audio duplex (src/client/audio.c in the browser)

let audioCtx = null, playCursor = 0;

function playAudioBatch(payload) {
  if (!audioCtx) return; // needs the user-gesture opt-in
  const batch = A.parseAudioBatch(payload);
  const samples = batch.samples, rate = batch.rate;
  // createBuffer throws on 0 frames or an out-of-range rate — a corrupt
  // packet must not take down the onmessage handler
  if (!samples.length || rate < 8000 || rate > 96000) return;
  const buf = audioCtx.createBuffer(1, samples.length, rate);
  buf.copyToChannel(samples, 0);
  const src = audioCtx.createBufferSource();
  src.buffer = buf;
  src.connect(audioCtx.destination);
  playCursor = Math.max(playCursor, audioCtx.currentTime + 0.05);
  src.start(playCursor);
  playCursor += samples.length / rate;
}

function enableAudio() {
  audioCtx = new (window.AudioContext || window.webkitAudioContext)({ sampleRate: 48000 });
  $("aud").disabled = true;
  // mic -> AUDIO_BATCH (f32le mono 48k, 480-sample frames)
  navigator.mediaDevices.getUserMedia({ audio: true }).then((stream) => {
    const src = audioCtx.createMediaStreamSource(stream);
    const proc = audioCtx.createScriptProcessor(512, 1, 1);
    let pending = new Float32Array(0);
    proc.onaudioprocess = (e) => {
      const inp = e.inputBuffer.getChannelData(0);
      const merged = new Float32Array(pending.length + inp.length);
      merged.set(pending);
      merged.set(inp, pending.length);
      let at = 0;
      while (merged.length - at >= 480) {
        if (ws && ws.readyState === 1)
          ws.send(A.packPacket(A.T.AUDIO_BATCH,
            A.audioBatchPayload(merged.subarray(at, at + 480), 48000)));
        at += 480;
      }
      pending = merged.subarray(at);
    };
    src.connect(proc);
    proc.connect(audioCtx.destination);
  }, (e) => { /* no mic: playback-only */ });
}

// ---------------------------------------------------------------------------
// camera uplink (IMAGE_FRAME RGB24, src/client/capture.c role)

let camTimer = null;

function toggleCamera() {
  if (camTimer) { clearInterval(camTimer); camTimer = null; $("cam").textContent = "share camera"; return; }
  const res = $("camres").value.split("x").map(Number);
  const w = res[0], h = res[1];
  navigator.mediaDevices.getUserMedia({ video: { width: w, height: h } })
    .then((stream) => {
      const video = document.createElement("video");
      video.srcObject = stream;
      return video.play().then(() => video);
    })
    .then((video) => {
      const canvas = document.createElement("canvas");
      canvas.width = w;
      canvas.height = h;
      const ctx = canvas.getContext("2d", { willReadFrequently: true });
      const rgb = new Uint8Array(w * h * 3);
      $("cam").textContent = "stop camera";
      camTimer = setInterval(() => {
        if (!ws || ws.readyState !== 1) return;
        ctx.drawImage(video, 0, 0, w, h);
        const img = ctx.getImageData(0, 0, w, h).data;
        for (let i = 0, j = 0; i < img.length; i += 4) {
          rgb[j++] = img[i]; rgb[j++] = img[i + 1]; rgb[j++] = img[i + 2];
        }
        ws.send(A.packPacket(A.T.IMAGE_FRAME, A.imageFramePayload(rgb, w, h)));
      }, 1000 / 15);
    });
}

// ---------------------------------------------------------------------------
// settings UI

function bindSettings() {
  $("mode").onchange = (e) => { settings.renderMode = +e.target.value; sendCaps(); };
  $("colors").onchange = (e) => { settings.colorLevel = +e.target.value; sendCaps(); };
  $("palette").onchange = (e) => { settings.palette = e.target.value; sendCaps(); };
  $("filter").onchange = (e) => { settings.colorFilter = +e.target.value; sendCaps(); };
  $("fps").onchange = (e) => { settings.desiredFps = +e.target.value; sendCaps(); };
  $("font").onchange = (e) => {
    settings.fontPx = +e.target.value;
    renderer.setFont(settings.fontPx);
    sendCaps();
  };
  $("settingsbtn").onclick = () => $("settings").classList.toggle("open");
  const filterSel = $("filter");
  FILTERS.forEach((name, i) => {
    const o = document.createElement("option");
    o.value = i;
    o.textContent = name;
    filterSel.appendChild(o);
  });
  Object.keys(PALETTES).forEach((name) => {
    const o = document.createElement("option");
    o.value = name;
    o.textContent = name;
    $("palette").appendChild(o);
  });
  document.addEventListener("keydown", (e) => {
    if (e.target.tagName === "INPUT") return;
    if (e.key === "m") { settings.renderMode = (settings.renderMode + 1) % 3; $("mode").value = settings.renderMode; sendCaps(); }
    else if (e.key === "c") { settings.colorLevel = (settings.colorLevel + 3) % 4; $("colors").value = settings.colorLevel; sendCaps(); }
    else if (e.key === "f") { settings.colorFilter = (settings.colorFilter + 1) % FILTERS.length; $("filter").value = settings.colorFilter; sendCaps(); }
    else if (e.key === "?") $("help").classList.toggle("open");
  });
}

// ---------------------------------------------------------------------------
// built-in render benchmark (?bench=local): synthesize a 203x64 truecolor
// half-block frame stream and measure parse+draw throughput with no server.

function synthFrame(cols, rows, t) {
  const parts = [];
  for (let y = 0; y < rows; y++) {
    let lastF = -1, lastB = -1;
    for (let x = 0; x < cols; x++) {
      const r = (x * 255 / cols + t * 7) & 255;
      const g = (y * 255 / rows + t * 13) & 255;
      const b = (x + y + t * 29) & 255;
      const f = ((r | 0) << 16) | ((g | 0) << 8) | (b | 0);
      const bb = ((b | 0) << 16) | ((r | 0) << 8) | (g | 0);
      if (f !== lastF) { parts.push(`\x1b[38;2;${r | 0};${g | 0};${b | 0}m`); lastF = f; }
      if (bb !== lastB) { parts.push(`\x1b[48;2;${b | 0};${r | 0};${g | 0}m`); lastB = bb; }
      parts.push("▀");
    }
    parts.push("\x1b[0m");
    if (y < rows - 1) parts.push("\n");
  }
  return parts.join("");
}

/* Chunked via requestAnimationFrame callbacks, not awaited Promises: 32
 * frames per rAF slice keeps the page responsive in a browser AND lets the
 * promise-job-free CI engine drive it to completion. `done(result)` fires
 * after the last slice; the result also lands in window.__bench. */
function benchLocal(cols, rows, frames, done) {
  cols = cols || 203; rows = rows || 64; frames = frames || 300;
  setStatus(`bench: ${cols}x${rows} x${frames}…`, "warn");
  // pre-generate a few distinct frames (content changes every frame, the
  // worst case for the diff path)
  const texts = [];
  for (let t = 0; t < 16; t++) texts.push(synthFrame(cols, rows, t));
  grid.parse(texts[0]); renderer.draw(grid); // warm
  let parseMs = 0, drawMs = 0, f = 0;
  const tStart = performance.now();
  function slice() {
    const stop = Math.min(f + 32, frames);
    for (; f < stop; f++) {
      const t0 = performance.now();
      grid.parse(texts[f & 15]);
      const t1 = performance.now();
      renderer.draw(grid);
      const t2 = performance.now();
      parseMs += t1 - t0;
      drawMs += t2 - t1;
    }
    if (f < frames) { requestAnimationFrame(slice); return; }
    const total = performance.now() - tStart;
    const fps = frames / (total / 1000);
    const result = {
      cols: cols, rows: rows, frames: frames, fps: +fps.toFixed(1),
      parseMsPerFrame: +(parseMs / frames).toFixed(3),
      drawMsPerFrame: +(drawMs / frames).toFixed(3),
      path: renderer.lastMode,
    };
    window.__bench = result;
    document.title = `bench: ${result.fps} fps`;
    $("hud").textContent = `BENCH ${cols}x${rows}: ${result.fps} fps ` +
      `(parse ${result.parseMsPerFrame}ms + draw ${result.drawMsPerFrame}ms, ` +
      `${result.path} path)`;
    setStatus("bench done", "ok");
    if (done) done(result);
  }
  slice();
}

// ---------------------------------------------------------------------------
// boot

window.addEventListener("DOMContentLoaded", () => {
  renderer = new CanvasRenderer($("screen"), { fontPx: settings.fontPx });
  bindSettings();
  $("send").onclick = sendChat;
  $("msg").addEventListener("keydown", (e) => { if (e.key === "Enter") sendChat(); });
  $("aud").onclick = enableAudio;
  $("cam").onclick = toggleCamera;
  window.__benchLocal = benchLocal; // headless drivers call this directly
  const q = new URLSearchParams(location.search);
  if (q.get("transport") === "webrtc") transportPref = "webrtc";
  if (q.get("bench") === "local") {
    benchLocal(+q.get("cols") || 203, +q.get("rows") || 64, +q.get("frames") || 300);
  } else {
    connect();
  }
});
