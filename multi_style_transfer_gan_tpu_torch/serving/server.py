"""Micro-batching style-transfer server (port of ``serving/server.py``).

Handler threads decode requests onto the model canvas; one dispatch thread
gathers up to ``max_batch`` of them (waiting at most ``max_wait_ms`` after
the first), pads to the fixed batch shape, queues the uint8 -> uint8
program of ``pipelines.batch.make_batch_fn`` on the device, and a resolver
thread copies each batch back and hands every request its slice.

- ``POST /stylize`` body = image bytes (jpeg/png/bmp) -> stylized PNG,
  aspect-restored as the reference's batch_process_images.py:412-438.
- ``GET /healthz`` -> 200 once the program is warmed up.
- ``GET /stats`` -> JSON counters, mean batch occupancy, images/s.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class Overloaded(Exception):
    """Request shed: the batcher's queue is at capacity (HTTP 503)."""


class _Slot:
    __slots__ = ("canvas", "event", "result", "error", "abandoned")

    def __init__(self, canvas):
        self.canvas = canvas
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.abandoned = False  # requester gave up; skip, don't compute


class MicroBatcher:
    """Gathers single-canvas requests into fixed-shape device batches.

    ``run_fn``: the (max_batch, C, C, 3) uint8 -> uint8 program; it returns
    a tensor, copied to the host by the resolver thread. ``max_queue``
    bounds admission (default 4 batches' worth): beyond it ``submit`` raises
    ``Overloaded`` at once, and requesters that time out mark their slot
    abandoned so the device never computes work nobody will read.
    """

    def __init__(self, run_fn, canvas: int, max_batch: int = 8,
                 max_wait_ms: float = 5.0, max_queue: int | None = None):
        self.run_fn = run_fn
        self.canvas = canvas
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.q: queue.Queue[_Slot] = queue.Queue(
            maxsize=max_queue if max_queue is not None else 4 * max_batch)
        self.requests = 0
        self.batches = 0
        self.images = 0
        self.shed = 0
        self._lock = threading.Lock()  # guards the counters above
        self._ema_batch_s = 0.0  # measured dispatch->resolved duration
        self._in_flight = 0      # batches dispatched but not yet resolved
        self._stop = threading.Event()
        # Two stages: the dispatch thread gathers and queues device batches,
        # the resolver copies results back and wakes requesters, so a
        # resolve never waits on the next gather and the copy back overlaps
        # the next batch. maxsize=1 gives depth-2 backpressure.
        self._out_q: queue.Queue = queue.Queue(maxsize=1)
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._resolver = threading.Thread(target=self._resolve_loop,
                                          daemon=True)
        self._dispatcher.start()
        self._resolver.start()

    def warmup(self):
        """Run the program once (builds the kernels) before serving."""
        zeros = np.zeros((self.max_batch, self.canvas, self.canvas, 3),
                         np.uint8)
        self.run_fn(zeros).cpu()

    def submit(self, canvas_u8: np.ndarray, timeout: float = 60.0):
        slot = _Slot(canvas_u8)
        try:
            self.q.put_nowait(slot)
        except queue.Full:
            with self._lock:
                self.shed += 1
            raise Overloaded("request queue full") from None
        with self._lock:
            self.requests += 1
        if not slot.event.wait(timeout):
            slot.abandoned = True  # worst case one extra slice is computed
            raise TimeoutError("stylize timed out")
        if slot.error is not None:
            raise slot.error
        return slot.result

    def close(self):
        self._stop.set()
        self.q.put(None)  # wake the dispatcher
        self._dispatcher.join(timeout=5)
        self._out_q.put(None)  # wake the resolver after the last batch
        self._resolver.join(timeout=5)

    def _gather(self, first_timeout: float | None = None,
                fill_wait: float | None = None) -> list[_Slot]:
        try:
            first = self.q.get(timeout=first_timeout)
        except queue.Empty:
            return []
        if first is None:
            return []
        slots = [first]
        deadline = time.monotonic() + (fill_wait if fill_wait is not None
                                       else self.max_wait)
        while len(slots) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self.q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            slots.append(nxt)
        return slots

    def _resolve(self, slots, pending_out):
        """Copy a dispatched batch to the host and wake its requests."""
        try:
            out = pending_out.cpu().numpy()
            for i, s in enumerate(slots):
                s.result = out[i]
        except BaseException as e:  # handed to every requester of the batch
            for s in slots:
                s.error = e
        finally:
            with self._lock:
                self.batches += 1
                self.images += len(slots)
            for s in slots:
                s.event.set()

    def _dispatch_loop(self):
        while not self._stop.is_set():
            # While a batch is in flight the device is busy for about one
            # batch duration anyway, so keep filling that long (EMA of the
            # measured batch times); when idle, dispatch after max_wait.
            if self._in_flight > 0:
                fill = max(self.max_wait, self._ema_batch_s)
                slots = self._gather(first_timeout=fill, fill_wait=fill)
            else:
                slots = self._gather()
            slots = [s for s in slots if not s.abandoned]
            if not slots:
                continue
            try:
                batch = np.zeros(
                    (self.max_batch, self.canvas, self.canvas, 3), np.uint8)
                for i, s in enumerate(slots):
                    batch[i] = s.canvas
                t0 = time.monotonic()
                out = self.run_fn(batch)  # queued on the device
            except BaseException as e:  # handed to every requester of the batch
                for s in slots:
                    s.error = e
                    s.event.set()
                with self._lock:
                    self.batches += 1
                    self.images += len(slots)
                continue
            with self._lock:
                self._in_flight += 1
            self._out_q.put((slots, out, t0))  # blocks at depth 2

    def _resolve_loop(self):
        while True:
            item = self._out_q.get()
            if item is None:
                return
            slots, out, t0 = item
            self._resolve(slots, out)
            with self._lock:
                self._in_flight -= 1
                self._ema_batch_s = (0.7 * self._ema_batch_s
                                     + 0.3 * (time.monotonic() - t0))


class StyleTransferService:
    """Decode -> micro-batch stylize -> aspect-restore encode, plus stats,
    with the program on ``device``."""

    def __init__(self, model, *, canvas: int = 256, max_batch: int = 8,
                 max_wait_ms: float = 5.0, mode: str = "cyclegan",
                 local_style_mode: str = "enhanced", strength: float = 0.8,
                 detail: float = 0.7, enhance_colors: bool = True,
                 smooth: bool = True, compute_dtype=None,
                 engine: str = "nhwc", max_queue: int | None = None,
                 device):
        from ..pipelines.batch import make_batch_fn

        self.canvas = canvas
        run_fn = make_batch_fn(model, mode, local_style_mode, strength,
                               detail, enhance_colors, smooth,
                               compute_dtype=compute_dtype, engine=engine,
                               device=device)
        self.batcher = MicroBatcher(run_fn, canvas, max_batch, max_wait_ms,
                                    max_queue=max_queue)
        self.t0 = time.monotonic()

    def warmup(self):
        self.batcher.warmup()
        self.t0 = time.monotonic()  # don't bill the kernel build to imgs/sec

    def stylize_bytes(self, data: bytes) -> bytes:
        """image bytes -> stylized PNG bytes (white-canvas aspect paste in,
        aspect crop + <= 1 MP resize back out).

        Raises ValueError for undecodable request bodies (a client error);
        Overloaded / TimeoutError when shedding; anything else is a server
        fault.
        """
        from ..ops.image import restore_aspect
        from ..pipelines.batch import _decode_canvas

        try:
            canvas_u8, (w, h) = _decode_canvas(io.BytesIO(data), self.canvas)
        except Exception as e:  # any decoder failure is the client's body
            raise ValueError(f"undecodable image: {e}") from e
        out = self.batcher.submit(canvas_u8)
        img = restore_aspect(out, (w, h), self.canvas)
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        return buf.getvalue()

    def stats(self) -> dict:
        b = self.batcher
        elapsed = max(time.monotonic() - self.t0, 1e-9)
        return {
            "requests": b.requests,
            "batches": b.batches,
            "images": b.images,
            "shed": b.shed,
            "mean_batch_occupancy": b.images / max(b.batches, 1),
            "images_per_sec": b.images / elapsed,
            "max_batch": b.max_batch,
            "canvas": self.canvas,
        }

    def close(self):
        self.batcher.close()


def _make_handler(services: dict):
    default_name = next(iter(services))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; /stats has the counters
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                stats = (services[default_name].stats()
                         if len(services) == 1 else
                         {k: s.stats() for k, s in services.items()})
                self._send(200, json.dumps(stats).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path != "/stylize":
                self._send(404, b"not found", "text/plain")
                return
            direction = parse_qs(url.query).get("direction",
                                                [default_name])[0]
            service = services.get(direction)
            if service is None:
                self._send(400, (f"error: unknown direction {direction!r}; "
                                 f"available: {sorted(services)}").encode(),
                           "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                png = service.stylize_bytes(self.rfile.read(n))
                self._send(200, png, "image/png")
            except ValueError as e:       # bad request body
                self._send(400, f"error: {e}".encode(), "text/plain")
            except (Overloaded, TimeoutError) as e:  # shedding: retryable
                self._send(503, f"error: {e}".encode(), "text/plain")
            except Exception as e:        # server fault; the server keeps running
                self._send(500, f"error: {e}".encode(), "text/plain")

    return Handler


def serve(service, host: str = "127.0.0.1",
          port: int = 8000, warmup: bool = True) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; call .serve_forever() or use the
    CLI). ``port=0`` picks a free port (``server.server_address``).

    ``service``: one StyleTransferService, or a dict {direction: service}
    for routing by ``POST /stylize?direction=...``; the first entry is the
    default when no direction is given.
    """
    services = (service if isinstance(service, dict)
                else {"default": service})
    if warmup:
        for s in services.values():
            s.warmup()
    return ThreadingHTTPServer((host, port), _make_handler(services))
