"""Browser viewer — the reference's web target redesigned for a GPU backend.

The reference ships the SAME app twice: native, and compiled to wasm for the
browser (treee-wasm/src/lib.rs:6-17 bootstraps ``treee::try_main`` under
wasm-bindgen; index.html loads it), with the web build hard-capped at 15M
points because the whole cloud must fit the tab's memory (laz.rs:49-62).

This framework inverts that split: the cloud and the renderer live on the
card, and the browser is a thin remote display — no point data ever leaves
the device, so the web surface scales to whatever the card (or the tiled
pipeline, parallel/tiles.py) holds instead of 15M.  ``serve.py`` is that
inversion, a dependency-free stdlib HTTP server over the Session/REPL:

  GET  /             one-file viewer page (canvas + mouse/keyboard mapping)
  GET  /frame.png    current frame as PNG (full / LOD / focused view);
                     ?wait=1&seq=N long-polls until a newer frame publishes
  GET  /frame.rgb    latest frame as raw RGB bytes (no PNG encode)
  POST /cmd          one REPL command line -> its text output (returns
                     right after the state mutation; rendering is async)
  GET  /info         session stats JSON

The page introduces NO new interaction semantics: every gesture maps to the
same REPL commands (repl.py), which map 1:1 to the reference's widgets and
mouse dispatch (interactive/mod.rs:713-954).  Start it with
``python -m treee_tpu.app --demo --serve 8080``.
"""

from __future__ import annotations

import io
import json
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .repl import Repl


def png_encode(img: np.ndarray) -> bytes:
    """Minimal RGB8 PNG writer (stdlib zlib; no imaging dependency).

    The viewer page polls frames, so encode speed matters more than ratio:
    filter type 0 on every row + one zlib deflate (level 6) keeps a 720p
    frame ~1-3 ms on the host.
    """
    h, w, c = img.shape
    assert c == 3 and img.dtype == np.uint8

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    raw = np.empty((h, 1 + w * 3), np.uint8)
    raw[:, 0] = 0  # per-row filter byte: None
    raw[:, 1:] = img.reshape(h, w * 3)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


# placeholder until the worker publishes its first frame
_EMPTY_PNG = png_encode(np.zeros((1, 1, 3), np.uint8))


_PAGE = """<!doctype html>
<meta charset="utf-8"><title>treee-tpu</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace;display:flex}
 #left{flex:1;display:flex;flex-direction:column;align-items:center}
 #frame{max-width:100%;image-rendering:pixelated;cursor:crosshair;
        border:1px solid #333;margin:8px}
 #panel{width:340px;padding:8px;display:flex;flex-direction:column;gap:6px}
 button,select,input{font:inherit;background:#222;color:#ddd;
        border:1px solid #444;padding:2px 6px}
 button.on{background:#264;border-color:#6a6}
 #log{flex:1;overflow-y:auto;white-space:pre-wrap;border:1px solid #333;
      padding:4px;min-height:120px}
 .row{display:flex;gap:4px;flex-wrap:wrap;align-items:center}
</style>
<div id=left><img id=frame></div>
<div id=panel>
 <div class=row id=modes></div>
 <div class=row>
  <label><input type=checkbox id=lod> lod</label>
  <label><input type=checkbox id=deleted> deleted</label>
  <label><input type=checkbox id=focus> focus</label>
  <select id=display><!--DISPLAY_OPTIONS--></select>
 </div>
 <div class=row>
  <label><input type=checkbox id=hull> hull</label>
  <label><input type=checkbox id=rbv> rbv</label>
  <label><input type=checkbox id=axis> axis</label>
 </div>
 <div class=row>d <input id=dist size=4 value=0.75>
  <button onclick="cmd('distance '+el('dist').value)">re-segment</button>
  <span id=stats></span></div>
 <input id=cli placeholder="command (try: help)">
 <div id=log></div>
</div>
<script>
const el=id=>document.getElementById(id);
const img=el('frame'); let focusMode=false;
/* one persistent long-poll: the server publishes frames from its render
   worker; this loop just displays the newest one (frame pipelining) */
let seq=0;
async function frameLoop(){
  for(;;){
    try{
      const r=await fetch('/frame.png?wait=1&seq='+seq);
      seq=+r.headers.get('X-Frame-Seq')||0;
      const u=URL.createObjectURL(await r.blob());
      const old=img.src; img.src=u;
      if(old.startsWith('blob:'))URL.revokeObjectURL(old);
    }catch(e){await new Promise(res=>setTimeout(res,500));}
  }
}
async function cmd(line,quiet){
  const r=await fetch('/cmd',{method:'POST',body:line});
  const j=await r.json();
  if(!quiet&&j.output)el('log').textContent+=j.output;
  el('log').scrollTop=1e9; stats(); return j;}
/* move coalescing: at most one move POST in flight.  ROTATE (left-drag)
   collapses queued positions to the newest — deltas fold server-side, so
   the rotation sum is preserved.  BRUSH (right/shift-drag) must keep
   every stroke point or the edit paints a gappy dotted line, so those
   positions QUEUE (bounded) and send in order. */
let movQ=[],movBusy=false;
function pumpMove(){
  if(movBusy||!movQ.length)return;
  movBusy=true;
  const[x,y]=movQ.shift();
  fetch('/cmd',{method:'POST',body:`event move ${x} ${y}`}).finally(()=>{
    movBusy=false;pumpMove();});}
function sendMove(x,y,keepAll){
  if(keepAll){if(movQ.length<256)movQ.push([x,y]);}
  else movQ=[[x,y]];
  pumpMove();}
async function stats(){
  const j=await(await fetch('/info')).json();
  el('stats').textContent=j.points.toLocaleString()+' pts / '
    +j.segments+' seg / sel '+(j.selected??'-')
    +' / '+(j.view_path??'full')
    +(j.frame_ms!=null?' '+j.frame_ms+' ms':'')
    +(j.render_error?' / RENDER ERROR: '+j.render_error:'');}
/* mode radio (Modus widget, interactive/mod.rs:958-968) */
const MODES=['view','draw','combine','spawn','delete'];let mode='view';
for(const m of MODES){const b=document.createElement('button');
  b.textContent=m;b.id='m_'+m;
  b.onclick=()=>{mode=m;cmd('mode '+m,true);
    MODES.forEach(x=>el('m_'+x).classList.toggle('on',x===mode));};
  el('modes').appendChild(b);}
el('m_view').classList.add('on');
/* raw pointer/key events -> the server-side InputController (input.py):
   ONE shared event->action layer — click discrimination, left-drag
   rotate, right/shift-drag brush, WASD — instead of re-implementing it
   here (program.rs:412-450, 555-622).  Shift maps to the right button
   for touchpads without one. */
function pix(e){const r=img.getBoundingClientRect();
  return[(e.clientX-r.left)*img.naturalWidth/r.width,
         (e.clientY-r.top)*img.naturalHeight/r.height];}
let downBtn=null;
img.oncontextmenu=e=>e.preventDefault();
img.onmousedown=e=>{
  downBtn=(e.button===2||e.shiftKey)?'right':'left';
  const[p,q]=pix(e);cmd(`event down ${downBtn} ${p} ${q}`,true);
  e.preventDefault();};
img.onmousemove=e=>{
  if(!downBtn)return;
  const[p,q]=pix(e);sendMove(p,q,downBtn==='right');};
img.onmouseup=e=>{
  if(!downBtn)return;
  const[p,q]=pix(e);cmd(`event up ${downBtn} ${p} ${q}`);downBtn=null;};
img.onwheel=e=>{e.preventDefault();
  cmd('event wheel '+(e.deltaY>0?1:-1),true);};
window.onkeydown=e=>{
  if(e.target===el('cli'))return;
  if('wasdqe'.includes(e.key))cmd('event key '+e.key+' 1',true);};
window.onkeyup=e=>{
  if(e.target===el('cli'))return;
  if('wasdqe'.includes(e.key))cmd('event key '+e.key+' 0',true);};
/* widgets -> commands */
el('lod').onchange=e=>cmd('lod '+(e.target.checked?'on':'off'),true);
el('deleted').onchange=e=>cmd('showdeleted '+(e.target.checked?'on':'off'),true);
el('focus').onchange=e=>{focusMode=e.target.checked;
  cmd('focusview '+(focusMode?'on':'off'),true);};
el('display').onchange=e=>cmd('display '+e.target.value,true);
for(const o of['hull','rbv','axis'])
  el(o).onchange=e=>cmd(`overlay ${o} `+(e.target.checked?'on':'off'),true);
el('cli').onkeydown=e=>{
  if(e.key==='Enter'){el('log').textContent+='> '+e.target.value+'\\n';
    cmd(e.target.value);e.target.value='';}};
frameLoop();stats();
</script>
"""


class ViewerServer:
    """Threaded HTTP server over one :class:`Repl` (and its Session).

    The Repl and its Session are stateful and own one device's state, so
    every request that touches the session serializes through
    ``self.lock``; the HTTP accept loop itself stays threaded so a slow
    frame doesn't wedge the page load.

    **Frame pipelining** (VERDICT r3/r4: match the reference's event-loop
    rendering, lib.rs:162-164 / program.rs:212): rendering runs on a
    dedicated worker thread, double-buffered.  ``POST /cmd`` mutates REPL
    state and returns immediately; it only *requests* a render
    (generation counter bump).  The worker always renders the NEWEST
    state, so a burst of drag-rotate commands coalesces into one render —
    input handling is fully decoupled from render latency.  The page
    holds one long-poll ``GET /frame.png?seq=N&wait=1`` that returns as
    soon as a newer frame (or ingest/segmentation preview) is published.
    ``GET /frame.rgb`` serves the latest frame as raw RGB bytes (no PNG
    encode) for programmatic clients.
    """

    def __init__(self, session, host: str = "127.0.0.1", port: int = 8080):
        self.repl = Repl(session, out=io.StringIO())
        self.lock = threading.Lock()
        # progressive feedback: long commands (open / add / distance) hold
        # the lock AND the device; they push preview frames here and
        # frame_png serves them lock-free so the page shows imagery before
        # the pipeline finishes (reference: live chunk streaming,
        # loading.rs:91-115, segmenting.rs:209-224)
        self._preview_png: bytes | None = None
        self._last_png: bytes | None = None
        self._last_img: np.ndarray | None = None
        self.repl.preview_hook = self._push_preview

        # render pipeline state (guarded by _frame_cond's lock, which is
        # NEVER held while touching the session/device)
        self._frame_cond = threading.Condition()
        self._req_gen = 0    # newest requested render generation
        self._done_gen = 0   # generation the worker has rendered through
        self._frame_seq = 0  # bumps on every published image (frame/preview)
        self._want_focus = False
        self._rendering = False  # worker holds self.lock for a render
        self._cmd_waiting = 0    # commands queued/running (worker defers)
        self._last_cmd_done = 0.0
        self._last_frame_ms: float | None = None   # last whole-cloud frame
        self._last_frame_path: str | None = None   # "full" / "adaptive(...)"
        self._render_error: Exception | None = None
        # sticky error string for diagnostics: after the FIRST successful
        # frame a persistently failing render would otherwise freeze the
        # canvas silently (stale frames keep serving) — this surfaces on
        # /info and as X-Render-Error on /frame.png until a render succeeds
        self._last_error_msg: str | None = None
        self._stop = False
        self._render_thread = threading.Thread(
            target=self._render_loop, daemon=True)
        self._render_thread.start()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet; the REPL log is the record
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._send(200, "text/html", viewer.page().encode())
                elif url.path == "/frame.png":
                    q = parse_qs(url.query)
                    # only an EXPLICIT focus param changes viewer state —
                    # the page's long-poll omits it (focusview command owns
                    # the toggle), and a default here would reset it
                    focus = (q["focus"][0] == "1") if "focus" in q else None
                    try:
                        if "wait" in q:
                            # long poll: return as soon as a frame newer
                            # than the client's seq is published
                            have = int(q.get("seq", ["0"])[0])
                            png, seq = viewer.frame_wait(have, focus)
                        else:
                            png = viewer.frame_png(focus)
                            seq = viewer.frame_seq
                    except Exception as e:  # surface in the tab, keep serving
                        self._send(500, "text/plain", str(e).encode())
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("X-Frame-Seq", str(seq))
                    err = viewer._last_error_msg
                    if err:
                        # a stale frame is being served because rendering
                        # is failing — make the frozen canvas diagnosable
                        self.send_header(
                            "X-Render-Error",
                            err.replace("\n", " ")[:500])
                    self.end_headers()
                    self.wfile.write(png)
                elif url.path == "/frame.rgb":
                    img, seq = viewer.frame_rgb()
                    if img is None:
                        self._send(503, "text/plain", b"no frame yet")
                        return
                    body = img.tobytes()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Width", str(img.shape[1]))
                    self.send_header("X-Height", str(img.shape[0]))
                    self.send_header("X-Frame-Seq", str(seq))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/info":
                    self._send(200, "application/json",
                               json.dumps(viewer.info()).encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if urlparse(self.path).path != "/cmd":
                    self._send(404, "text/plain", b"not found")
                    return
                n = int(self.headers.get("Content-Length", 0))
                line = self.rfile.read(n).decode()
                out = viewer.command(line)
                self._send(200, "application/json", json.dumps(out).encode())

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    # ---- session access (all under the lock) ------------------------------

    def page(self) -> str:
        """Viewer page with the display selector limited to what this scan
        can actually show (the REPL rejects absent attributes, repl.py
        `display`; offering them in the dropdown would just no-op)."""
        with self.lock:  # 'add scan.las' replaces session.attributes
            opts = ["classification", "expansion", "height", "curve",
                    "shaded", *sorted(self.repl.s.attributes), "hag"]
        return _PAGE.replace(
            "<!--DISPLAY_OPTIONS-->",
            "".join(f"<option>{o}</option>" for o in opts),
        )

    def command(self, line: str) -> dict:
        # server-level command: the focused-view toggle is viewer state
        # (which frame variant the worker renders), not REPL state
        stripped = line.strip().split()
        if stripped and stripped[0] == "focusview":
            want = len(stripped) > 1 and stripped[1] == "on"
            with self._frame_cond:
                self._want_focus = want
                self._req_gen += 1
                self._frame_cond.notify_all()
            return {"ok": True, "output": "", "quit": False}
        # priority over the render worker: while commands are waiting the
        # worker defers (briefly), so a burst of drag events runs back to
        # back instead of each queueing behind a whole render
        with self._frame_cond:
            self._cmd_waiting += 1
        try:
            with self.lock:
                self.repl.out = io.StringIO()
                alive = self.repl.handle(line)
                out = {"ok": True, "output": self.repl.out.getvalue(),
                       "quit": not alive}
        finally:
            with self._frame_cond:
                self._cmd_waiting -= 1
                self._last_cmd_done = time.monotonic()
                self._frame_cond.notify_all()
        # returns immediately after the state mutation: rendering is the
        # worker's job (one render per burst of commands, newest state)
        self.request_render()
        return out

    def request_render(self) -> int:
        """Ask the worker for a render of the CURRENT state; coalesces."""
        with self._frame_cond:
            self._req_gen += 1
            self._frame_cond.notify_all()
            return self._req_gen

    def _push_preview(self, img: np.ndarray) -> None:
        with self._frame_cond:
            self._preview_png = png_encode(np.asarray(img))
            self._frame_seq += 1  # wake long-polls: fresher imagery exists
            self._frame_cond.notify_all()

    @property
    def frame_seq(self) -> int:
        with self._frame_cond:
            return self._frame_seq

    def _render_loop(self) -> None:
        """Worker: render whenever a newer generation is requested.

        Snapshots the newest requested generation, renders ONCE, and marks
        every request up to that generation done — a burst of drag-rotates
        costs one render of the final camera.  The session lock is only
        held for the render itself, so commands interleave freely.
        """
        while True:
            with self._frame_cond:
                while self._req_gen == self._done_gen and not self._stop:
                    self._frame_cond.wait(0.5)
                if self._stop:
                    return
                # yield to command bursts: render only after a short
                # quiescence window (30 ms since the last command), bounded
                # at 100 ms so a continuous drag stream can't starve frames.
                # THEN snapshot the newest generation — one render covers
                # the whole burst that just ran.
                yield_until = time.monotonic() + 0.1
                while time.monotonic() < yield_until and (
                        self._cmd_waiting
                        or time.monotonic() - self._last_cmd_done < 0.03):
                    self._frame_cond.wait(0.01)
                gen = self._req_gen
                focus = self._want_focus
            try:
                # _rendering distinguishes "worker holds the session" from
                # "a long REPL command holds it" for frame_png's preview
                # fallback.  Set OPTIMISTICALLY before a non-blocking
                # acquire and cleared on failure: the flag is thus already
                # True whenever the worker actually holds the lock (no
                # stale-frame race window), while a worker QUEUED behind a
                # long command leaves it False so the preview path serves
                # (review r4)
                while True:
                    if not self.lock.locked():  # cheap peek before toggling
                        with self._frame_cond:
                            self._rendering = True
                        if self.lock.acquire(blocking=False):
                            break
                        with self._frame_cond:
                            self._rendering = False
                    # a command holds the session: wait for its completion
                    # notify instead of busy-polling (1-CPU host)
                    with self._frame_cond:
                        if self._stop:
                            return
                        self._frame_cond.wait(0.05)
                try:
                    img = np.asarray(self._frame_img_locked(focus))
                finally:
                    self.lock.release()
                    with self._frame_cond:
                        self._rendering = False
                png = png_encode(img)
            except Exception as e:
                # a broken render must not kill the worker; the failed
                # generation is marked done so the loop doesn't spin, and
                # the error surfaces on the next synchronous frame_png
                with self._frame_cond:
                    self._render_error = e
                    self._last_error_msg = f"{type(e).__name__}: {e}"
                    self._done_gen = gen
                    self._frame_cond.notify_all()
                continue
            with self._frame_cond:
                self._render_error = None
                self._last_error_msg = None
                self._last_img = img
                self._last_png = png
                # a real frame supersedes any pushed preview; keeping the
                # old preview would flash an outdated coarse image during
                # the NEXT lock-holding command that pushes none
                self._preview_png = None
                self._done_gen = gen
                self._frame_seq += 1
                self._frame_cond.notify_all()

    def frame_wait(self, have_seq: int, focus: bool | None = None,
                   timeout: float = 20.0) -> tuple[bytes, int]:
        """Long poll: block until a frame newer than ``have_seq`` is
        published (or timeout), then return (png, seq)."""
        deadline = time.monotonic() + timeout
        with self._frame_cond:
            if focus is not None and focus != self._want_focus:
                self._want_focus = focus
                self._req_gen += 1
                self._frame_cond.notify_all()
            if self._render_error is not None and self._last_png is None:
                # no frame has EVER rendered and the worker is failing:
                # surface the error to the tab (HTTP 500) instead of a
                # silent blank-canvas retry loop (review r4)
                e, self._render_error = self._render_error, None
                raise e
            if self._last_png is None and self._req_gen == self._done_gen:
                self._req_gen += 1  # first client: make a frame exist
                self._frame_cond.notify_all()
            while self._frame_seq <= have_seq:
                if self._render_error is not None and self._last_png is None:
                    # the render we are waiting on just failed and nothing
                    # has ever rendered: fail fast, not after the timeout
                    e, self._render_error = self._render_error, None
                    raise e
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._frame_cond.wait(min(left, 0.5))
            png = self._preview_png or self._last_png or _EMPTY_PNG
            return png, self._frame_seq

    def frame_png(self, focus: bool | None = None,
                  timeout: float = 120.0) -> bytes:
        """Freshest frame of the current state (synchronous surface).

        Requests a render and waits for it — UNLESS a REPL command holds
        the session (long pipeline run): then the freshest preview or the
        last real frame is served instead of wedging the poll loop.
        """
        import time

        gen = None
        with self._frame_cond:
            if focus is not None and focus != self._want_focus:
                self._want_focus = focus
            gen = self._req_gen = self._req_gen + 1
            self._frame_cond.notify_all()
        deadline = time.monotonic() + timeout
        while True:
            with self._frame_cond:
                if self._done_gen >= gen:
                    if self._render_error is not None:
                        e, self._render_error = self._render_error, None
                        raise e
                    return self._last_png or self._preview_png or _EMPTY_PNG
                # a command (not our worker) holds the session: don't wait
                cmd_busy = self.lock.locked() and not self._rendering
                if cmd_busy:
                    cached = self._preview_png or self._last_png
                    if cached is not None:
                        return cached
                if time.monotonic() > deadline:
                    return self._preview_png or self._last_png or _EMPTY_PNG
                self._frame_cond.wait(0.05)

    def frame_rgb(self) -> tuple[np.ndarray | None, int]:
        """Latest rendered frame as a raw RGB array (no PNG encode)."""
        with self._frame_cond:
            return self._last_img, self._frame_seq

    def _frame_img_locked(self, focus: bool = False) -> np.ndarray:
        r = self.repl
        if focus and r.selected is not None:
            img = r.s.render_focus(
                r.selected, display=r.display,
                show_hull=r.overlays["hull"],
                show_rbv=r.overlays["rbv"],
                show_axis=r.overlays["axis"],
                hull_include=r.hull_include,
                rbv_slices=r.rbv_opts["slices"],
                rbv_sectors=r.rbv_opts["sectors"],
                rbv_method=r.rbv_opts["method"],
                rbv_symmetric=r.rbv_opts["symmetric"],
                axis_algo=r.axis_algo,
            )
        else:
            from .repl import ATTR_DISPLAYS

            # auto view path + camera-stale adaptive refresh (repl owns
            # the policy: full below ~1M live points, auto-tau above)
            r.prepare_frame()
            prop, pal = (None, None)
            if r.display in ATTR_DISPLAYS:
                prop, pal = r.s.attribute_prop(r.display)
            elif r.display == "hag":
                prop = r.s.hag_prop()
            t0 = time.monotonic()
            img = r.s.render(use_lod=r.use_lod,
                             show_deleted=r.show_deleted,
                             prop=prop, palette=pal)
            # wall time around the blocking render call: dispatch-inclusive,
            # which is what the user actually waits for per frame
            self._last_frame_ms = (time.monotonic() - t0) * 1e3
            self._last_frame_path = r.view_path
        return np.asarray(img)

    def info(self) -> dict:
        with self.lock:
            s = self.repl.s
            n_seg = (
                int(np.asarray(s.table.present).sum())
                if s.table is not None else 0
            )
            return {
                "points": int(s.cloud.count),
                "segments": n_seg,
                "mode": self.repl.mode,
                "selected": self.repl.selected,
                "lod": self.repl.use_lod,
                "width": s.config.render.width,
                "height": s.config.render.height,
                # latency budget, user-visible (VERDICT r4 task 6): which
                # render path served the last frame and what it cost
                "view_path": self._last_frame_path or self.repl.view_path,
                "frame_ms": (round(self._last_frame_ms, 1)
                             if self._last_frame_ms is not None else None),
                # diagnosability: non-null while renders are failing (the
                # canvas may be serving stale frames)
                "render_error": self._last_error_msg,
            }

    # ---- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        with self._frame_cond:
            self._stop = True
            self._frame_cond.notify_all()
        self._render_thread.join(timeout=120)
        self.httpd.shutdown()
        self.httpd.server_close()
