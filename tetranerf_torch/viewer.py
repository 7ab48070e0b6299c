"""Interactive web viewer of a :class:`~.training.trainer.Trainer`'s model.

Counterpart of :mod:`tetranerf_tpu.viewer`: a stdlib HTTP server that
serves an orbit-control page and answers its frame requests with PNGs
(encoded by :mod:`.utils.png`; no Pillow).

- While the camera moves, frames render in fast mode: coarse samples only,
  ``fast_samples`` of them, at the page's reduced side
  (``Trainer.render_rays``).
- When the camera holds still, the page asks for the full frame in 8 row
  bands. Each band is marched once (``Trainer.cache_camera``, depth-sorted)
  and re-shaded at full quality from that march
  (``Trainer.render_cached`` with adaptive budgets) for as long as the
  trainer's ``march_version`` stays the same; the 8 most recent marches are
  kept.

Usage::

    tetranerf-torch-viewer --checkpoint out/final --data data/scene [--port 7007]

or during training (``tetranerf-torch-train --viewer-port 7007``)::

    viewer = ViewerServer(trainer, port=7007).start()  # a background thread
    ...
    viewer.stop()

Frames and train steps take turns on the trainer's lock, so a frame never
reads the parameters while the optimizer writes them. A render error is
answered with HTTP 500 and its message.

A trainer whose field is split over model shards (``num_model_shards`` > 1)
needs every rank of its model group for a frame, and a collective issued
from an HTTP thread beside the training thread could deadlock the group. So
its frames take turns with the steps on the ranks instead:

- every rank builds a ``ViewerServer`` of its trainer (the ranks' march
  versions are checked equal once, over the world), and rank 0 alone opens
  the socket (:meth:`ViewerServer.start`). Its HTTP threads queue each
  request and wait for the reply; they never touch the trainer;
- ``Trainer.fit(..., viewer=...)`` calls :meth:`ViewerServer.serve_queued`
  at every step boundary on every rank. The ranks of data index 0 take one
  broadcast over their model group (rank 0's count of queued requests,
  then each one's pose, side, quality and rows), render each frame together
  with the same ``_render`` and march caches (geometry only, keyed by
  ``march_version``, so they agree), and rank 0 encodes the PNG and
  answers. The other data ranks go on to the next step's ``all_reduce``;
- when ``fit`` ends the queue is served once more and closed until the
  next ``fit`` starts: a request that comes in between, or that
  :meth:`ViewerServer.stop` finds waiting, is refused with HTTP 503.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from .utils.png import encode_png


class FrameRefused(RuntimeError):
    """A queued frame of a model-sharded trainer that no step boundary will
    serve: ``fit`` has ended or the server stopped (HTTP 503)."""


@dataclass
class _Request:
    """A frame queued on rank 0 by an HTTP thread, and its reply."""

    position: tuple
    side: int
    quality: str
    mode: str
    rows: tuple
    done: threading.Event = field(default_factory=threading.Event)
    png: Optional[bytes] = None
    error: Optional[BaseException] = None

    def pack(self) -> list:
        """The 7 numbers every model rank needs to render the frame."""
        return [*map(float, self.position), float(self.side),
                float(self.quality == "full"), *map(float, self.rows)]

# The page and the numpy camera helpers are copies of the JAX package's.
_PAGE = """<!DOCTYPE html>
<html><head><title>tetranerf-torch viewer</title><style>
body { margin:0; background:#111; color:#ddd; font:13px sans-serif; }
#hud { position:fixed; top:8px; left:8px; background:#0008; padding:6px 10px;
       border-radius:6px; }
img { width:100vw; height:100vh; object-fit:contain; display:block;
      image-rendering:auto; }
</style></head><body>
<div id="hud">drag: orbit &middot; wheel: dolly &middot; quality refines on
hold &middot; keys 1/2/3: rgb/depth/acc &middot; <span id="mode"></span>
<span id="stat"></span></div>
<img id="view" />
<script>
let az = 0.6, el = 0.3, r = 2.5, busy = false, still = 0, gen = 0;
let mode = 'rgb';
const img = document.getElementById('view');
const stat = document.getElementById('stat');
const modeEl = document.getElementById('mode');
window.addEventListener('keydown', e => {
  const m = {'1':'rgb', '2':'depth', '3':'accumulation'}[e.key];
  if (m) { mode = m; modeEl.textContent = m + ' '; still = 0; render('fast'); }
});
function pose() {
  const cx = Math.cos(az)*Math.cos(el)*r, cy = Math.sin(az)*Math.cos(el)*r,
        cz = Math.sin(el)*r;
  return [cx, cy, cz];
}
async function render(quality) {
  if (busy) return; busy = true;
  try { await renderInner(quality); }
  catch (e) { stat.textContent = 'error: ' + e; }
  finally { busy = false; }
}
async function renderInner(quality) {
  const myGen = ++gen;
  const t0 = performance.now();
  if (quality == 'full') {
    // Progressive: full-res frame arrives in row-band tiles, each
    // composited as soon as its strip renders.
    const side = 800, tiles = 8, band = side / tiles;
    const cv = document.createElement('canvas');
    cv.width = side; cv.height = side;
    const ctx = cv.getContext('2d');
    if (img.complete && img.naturalWidth)
      ctx.drawImage(img, 0, 0, side, side);  // last frame as backdrop
    for (let t = 0; t < tiles; t++) {
      const res = await fetch('/render', {method:'POST',
        body: JSON.stringify({position: pose(), quality: 'full',
          mode: mode, side: side, rows: [t*band, (t+1)*band]})});
      if (myGen !== gen) return;
      const bmp = await createImageBitmap(await res.blob());
      ctx.drawImage(bmp, 0, t*band);
      img.src = cv.toDataURL();
      stat.textContent = 'full ' + (t+1) + '/' + tiles + ' ' +
        ((performance.now()-t0)/1000).toFixed(2) + 's';
    }
  } else {
    const res = await fetch('/render', {method:'POST', body: JSON.stringify(
      {position: pose(), quality: quality, mode: mode, side: 400})});
    const blob = await res.blob();
    if (myGen === gen) {
      img.src = URL.createObjectURL(blob);
      stat.textContent = quality + ' ' +
        ((performance.now()-t0)/1000).toFixed(2) + 's';
    }
  }
}
let dragging = false, px = 0, py = 0;
window.addEventListener('mousedown', e => {dragging = true; px = e.x; py = e.y;});
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  az -= (e.x - px) * 0.01; el += (e.y - py) * 0.01;
  el = Math.max(-1.4, Math.min(1.4, el));
  px = e.x; py = e.y; still = 0; render('fast');
});
window.addEventListener('wheel', e => {
  r *= Math.exp(e.deltaY * 0.001); r = Math.max(1.2, Math.min(8, r));
  still = 0; render('fast');
});
setInterval(() => { if (++still == 3) render('full'); }, 350);
render('fast');
</script></body></html>"""


def _colorize(out, shape, mode: str) -> np.ndarray:
    """Map a render-output dict to a uint8 image of ``shape=(h, w)``."""
    h, w = shape
    if mode == "depth":
        depth = np.asarray(out["depth"]).reshape(h, w)
        acc = np.asarray(out["accumulation"]).reshape(h, w)
        covered = depth[acc > 0.5]
        # Normalize to the covered range so the geometry uses the full
        # gray ramp regardless of scene scale (empty pixels -> black).
        lo = float(covered.min()) if covered.size else 0.0
        hi = float(np.percentile(covered, 99.0)) if covered.size else 1.0
        g = np.clip((depth - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
        g = np.where(acc > 0.05, 1.0 - g * 0.9, 0.0)  # near=bright
        return (g * 255).astype(np.uint8)
    if mode == "accumulation":
        acc = np.clip(np.asarray(out["accumulation"]).reshape(h, w), 0, 1)
        return (acc * 255).astype(np.uint8)
    rgb = np.clip(np.asarray(out["rgb"]).reshape(h, w, 3), 0, 1)
    return (rgb * 255).astype(np.uint8)


def _look_at(pos):
    pos = np.asarray(pos, np.float64)
    forward = -pos / np.linalg.norm(pos)
    upw = np.array([0.0, 0.0, 1.0])
    if abs(forward @ upw) > 0.98:
        upw = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, upw)
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -forward, pos
    return c2w


def _camera_rays(c2w, side, camera_angle_x=0.8):
    focal = 0.5 * side / np.tan(0.5 * camera_angle_x)
    j, i = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    dirs = np.stack(
        [
            (i - side / 2 + 0.5) / focal,
            -(j - side / 2 + 0.5) / focal,
            -np.ones_like(i, np.float64),
        ],
        axis=-1,
    )
    d = dirs @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    return (
        np.ascontiguousarray(o.reshape(-1, 3), np.float32),
        np.ascontiguousarray(d.reshape(-1, 3), np.float32),
    )


class ViewerServer:
    """Serves the orbit viewer of ``trainer``'s current model.

    ``fast`` frames render ``fast_samples`` coarse samples and no fine
    round; ``full`` frames re-shade a cached depth-sorted march of the
    pose's rays, marched again whenever the trainer's ``march_version``
    moves. Rays go through the model in chunks of ``chunk``.

    With model shards every rank builds one (a collective), rank 0 starts
    it, and each rank passes its own to ``Trainer.fit(viewer=...)``, whose
    step boundaries serve the queued frames (the module's docstring)."""

    def __init__(self, trainer, port: int = 7007, camera_angle_x: float = 0.8,
                 fast_samples: int = 32, chunk: int = 16384, host: str = "0.0.0.0"):
        self.trainer = trainer
        self.port = port
        self.host = host
        self.camera_angle_x = camera_angle_x
        self.fast_samples = fast_samples
        self.chunk = chunk
        # Marches keyed by (pose, side, rows, march_version), oldest first:
        # room for one progressive pose (8 row bands), since each holds its
        # rays' intervals and vertex streams on the device.
        self._caches: dict = {}
        self._max_caches = 8
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        # Model shards: the frames queued on rank 0 for the next step
        # boundary, and whether the queue is closed (fit has ended).
        self._queue: list = []
        self._queue_lock = threading.Lock()
        self._closed = False
        if self.sharded:
            trainer.group.check_same("the march version", torch.tensor(
                [trainer.march_version], device=trainer.group.device))

    @property
    def sharded(self) -> bool:
        """The trainer's field is split over model shards: frames are served
        at the step boundaries of ``fit`` (:meth:`serve_queued`)."""
        return self.trainer.model.field_group is not None

    # ------------------------------------------------------------- render
    def render_frame(self, position, side: int, quality: str, mode: str = "rgb",
                     rows: Optional[tuple] = None) -> bytes:
        """PNG bytes of a ``side`` x ``side`` camera at ``position`` looking
        at the origin: ``mode`` ``"rgb"``, ``"depth"`` (normalised, gray) or
        ``"accumulation"`` (gray); ``rows=(y0, y1)`` renders only that band
        of rows, with its own cached march."""
        y0, y1 = (0, side) if rows is None else (int(rows[0]), int(rows[1]))
        if not 0 <= y0 < y1 <= side:
            raise ValueError(f"bad rows {rows} for side {side}")
        if self.sharded:
            position = tuple(float(x) for x in position)
            _look_at(position)  # a bad pose fails here, not on the ranks
            return self._queued_frame(_Request(position, side, quality, mode, (y0, y1)))
        out = self._frame_outputs(position, side, quality, (y0, y1))
        return encode_png(_colorize(out, (y1 - y0, side), mode))

    def _frame_outputs(self, position, side: int, quality: str, rows: tuple):
        """The render outputs of rows ``[y0, y1)`` of a frame."""
        c2w = _look_at(position)
        o, d = _camera_rays(c2w, side, self.camera_angle_x)
        y0, y1 = rows
        o = o.reshape(side, side, 3)[y0:y1].reshape(-1, 3)
        d = d.reshape(side, side, 3)[y0:y1].reshape(-1, 3)
        with self._lock:
            return self._render(o, d, c2w, side, quality, y0, y1)

    # ------------------------------------------------- model-shard frames
    def _queued_frame(self, req: _Request) -> bytes:
        """Queue ``req`` for the next step boundary and wait for its PNG."""
        with self._queue_lock:
            if self._closed:
                raise FrameRefused("training has ended: no step will serve this frame")
            self._queue.append(req)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.png

    def serve_queued(self, last: bool = False) -> int:
        """Serve the frames queued on rank 0, on every rank of data index 0
        together (a no-op on the other ranks and without model shards);
        every rank of the world calls it at the same step boundary. With
        ``last`` the queue closes with these frames: a later request is
        refused until :meth:`open_queue`. Returns the frame count."""
        trainer = self.trainer
        if not self.sharded or not trainer.evaluates:
            return 0
        group = trainer.group
        with self._queue_lock:
            pending, self._queue = self._queue, []
            self._closed = self._closed or last
        count = torch.tensor([len(pending)], dtype=torch.int64, device=group.device)
        group.broadcast_model(count)
        count = int(count)
        if count == 0:
            return 0
        params = torch.zeros((count, 7), dtype=torch.float64, device=group.device)
        if pending:
            params.copy_(torch.tensor([r.pack() for r in pending], dtype=torch.float64))
        group.broadcast_model(params)
        for i, row in enumerate(params.cpu().tolist()):
            req = pending[i] if pending else None
            try:
                out = self._frame_outputs(tuple(row[:3]), int(row[3]),
                                          "full" if row[4] else "fast",
                                          (int(row[5]), int(row[6])))
                if req is not None:
                    req.png = encode_png(_colorize(out, (req.rows[1] - req.rows[0],
                                                         req.side), req.mode))
            except Exception as exc:  # a frame error: rank 0 answers HTTP 500
                if req is not None:
                    req.error = exc
            if req is not None:
                req.done.set()
        return count

    def open_queue(self) -> None:
        """Accept requests again after a :meth:`serve_queued` that closed
        the queue (``Trainer.fit`` calls it when it starts)."""
        with self._queue_lock:
            self._closed = False

    def _refuse_queued(self) -> None:
        with self._queue_lock:
            pending, self._queue = self._queue, []
            self._closed = True
        for req in pending:
            req.error = FrameRefused("the viewer stopped before a step served this frame")
            req.done.set()

    def _render(self, o, d, c2w, side: int, quality: str, y0: int, y1: int):
        trainer = self.trainer
        if quality != "full":
            return trainer.render_rays(o, d, chunk=self.chunk,
                                       num_samples=self.fast_samples, num_fine_samples=0)
        # A march made before the occupancy column, the cap or the bounds
        # moved would miss what they now let through: the version is in
        # the key.
        key = c2w.tobytes() + np.int64([side, y0, y1, trainer.march_version]).tobytes()
        cache = self._caches.get(key)
        if cache is None:
            cache = trainer.cache_camera(o, d, chunk=self.chunk, sort_by_depth=True)
            while len(self._caches) >= self._max_caches:
                self._caches.pop(next(iter(self._caches)))
            self._caches[key] = cache
        return trainer.render_cached(cache, adaptive_samples=True)

    # ------------------------------------------------------------- server
    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                if self.path not in ("/", "/index.html"):
                    self.send_error(404)
                    return
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/render":
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n))
                    png = viewer.render_frame(
                        req["position"], int(req.get("side", 400)),
                        str(req.get("quality", "fast")), str(req.get("mode", "rgb")),
                        req.get("rows"),
                    )
                except FrameRefused as exc:
                    self.send_error(503, str(exc))
                    return
                except Exception as exc:  # the page shows render errors
                    self.send_error(500, str(exc))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)

        return Handler

    def start(self, background: bool = True) -> "ViewerServer":
        """Bind ``host:port`` (port 0: any free port, then read
        :attr:`port`) and serve, on a daemon thread when ``background``."""
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._handler())
        self.port = self._httpd.server_address[1]
        if background:
            threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        else:
            self._httpd.serve_forever()
        return self

    def stop(self) -> None:
        """Close the socket; frames still queued are refused (HTTP 503)."""
        self._refuse_queued()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
