"""HTTP serving for NeuroEncoder checkpoints, on the card.

Counterpart of ``neurovit_tpu/serving_http.py`` with the same routes and
JSON: a threaded HTTP server around the bucketed
:class:`~neurovit_tpu_torch.serving.Predictor` with cross-request
micro-batching -- concurrent ``POST /predict`` requests are coalesced into
one batch (grouped by volume shape, routed to the smallest bucket that
fits).

    python -m neurovit_tpu_torch.serving_http --config config.yaml --port 8000
    curl -s --data-binary @scan.nii localhost:8000/predict

Endpoints:
  GET  /healthz            liveness + model/bucket metadata (JSON)
  POST /predict[?crop=0]   body = one NIfTI (.nii or gzipped .nii.gz);
                           response = one JSON row per (file, timepoint),
                           with the batch CLI's ADNI preprocessing; a 4D
                           checkpoint answers one row, timepoint -1, for
                           the whole series.
"""

from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

from neurovit_tpu_torch.serving import (Predictor, _collect_volume_jobs,
                                        add_serving_args,
                                        predictor_from_cli_args)

# Gzip magic: POST bodies are sniffed, not extension-typed.
_GZ_MAGIC = b"\x1f\x8b"


class _Pending:
    """One volume awaiting a batched prediction."""

    __slots__ = ("volume", "event", "label", "probs", "error")

    def __init__(self, volume: np.ndarray):
        self.volume = volume
        self.event = threading.Event()
        self.label = None
        self.probs = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Coalesce concurrent prediction requests into shared batches.

    Handler threads enqueue volumes; one dispatcher thread drains the
    queue, waits up to ``window`` seconds for co-arriving work (bounded at
    the predictor's ``batch_size``), groups by volume shape, and runs each
    group through the predictor. The dispatcher is the only thread that
    touches the predictor and the device.
    """

    def __init__(self, predictor: Predictor, window: float = 0.005):
        self.predictor = predictor
        self.window = window
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-http-batcher")
        self._thread.start()

    def predict(self, volumes: List[np.ndarray]):
        """Block until every volume is predicted (possibly across several
        shared batches); returns (labels, probs) aligned with ``volumes``."""
        pending = [_Pending(v) for v in volumes]
        for p in pending:
            self._queue.put(p)
        for p in pending:
            p.event.wait()
            if p.error is not None:
                raise p.error
        return ([p.label for p in pending],
                np.stack([p.probs for p in pending]))

    def _loop(self) -> None:
        import time

        while not self._stop.is_set():
            try:
                items = [self._queue.get(timeout=0.1)]
            except queue.Empty:
                continue
            deadline = time.monotonic() + self.window
            while len(items) < self.predictor.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            by_shape = {}
            for item in items:
                by_shape.setdefault(item.volume.shape, []).append(item)
            for group in by_shape.values():
                try:
                    labels, probs = self.predictor(
                        np.stack([g.volume for g in group]))
                    for g, label, p in zip(group, labels, probs):
                        g.label, g.probs = int(label), np.asarray(p)
                except BaseException as exc:  # surface on the caller
                    for g in group:
                        g.error = exc
                finally:
                    for g in group:
                        g.event.set()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def _decode_nifti_jobs(body: bytes, crop: bool, sequence: bool = False
                       ) -> List[Tuple[int, np.ndarray]]:
    """Parse one POSTed NIfTI body into (timepoint, volume) samples with
    the batch CLI's preprocessing (per timepoint, or with ``sequence`` the
    whole series as timepoint -1), through a temp file into
    serving._collect_volume_jobs. Gzipped bodies decompress in memory (a
    temp ``.nii.gz`` per request would grow the decompressed-file cache)."""
    if body[:2] == _GZ_MAGIC:
        import gzip
        body = gzip.decompress(body)
    fd, path = tempfile.mkstemp(suffix=".nii")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(body)
        return [(t, vol) for _, t, vol in
                _collect_volume_jobs([path], crop=crop, sequence=sequence)]
    finally:
        os.unlink(path)


def make_server(predictor: Predictor, host: str = "127.0.0.1",
                port: int = 8000, window: float = 0.005):
    """Build (but don't start) the HTTP server; returns (server, batcher).
    ``server.serve_forever()`` runs it; stop with ``server.shutdown()`` and
    ``batcher.stop()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    batcher = MicroBatcher(predictor, window=window)
    sequence = bool(predictor.model.is_4d)

    class Handler(BaseHTTPRequestHandler):

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path.split("?")[0] != "/healthz":
                self._send(404, {"error": f"no route {self.path}"})
                return
            self._send(200, {
                "status": "ok",
                "is_4d": sequence,
                "batch_size": predictor.batch_size,
                "buckets": list(predictor.bucket_sizes),
                "quant": predictor.quant,
            })

        def do_POST(self):  # noqa: N802
            route, _, query = self.path.partition("?")
            if route != "/predict":
                self._send(404, {"error": f"no route {route}"})
                return
            crop = "crop=0" not in query
            length = int(self.headers.get("Content-Length") or 0)
            if length <= 0:
                self._send(400, {"error": "empty body (expected one "
                                          ".nii/.nii.gz)"})
                return
            body = self.rfile.read(length)
            try:
                jobs = _decode_nifti_jobs(body, crop=crop, sequence=sequence)
            except Exception as exc:
                self._send(400, {"error": f"unreadable NIfTI: {exc}"})
                return
            try:
                labels, probs = batcher.predict([v for _, v in jobs])
            except Exception as exc:
                self._send(500, {"error": f"prediction failed: {exc}"})
                return
            self._send(200, {"rows": [
                {"timepoint": t, "prediction": label,
                 "probs": [float(v) for v in p]}
                for (t, _), label, p in zip(jobs, labels, probs)]})

        def log_message(self, fmt, *fmt_args):  # quiet request log
            pass

    class Server(ThreadingHTTPServer):
        # A burst of concurrent clients overflows socketserver's default
        # listen backlog of 5; coalescing bursts is this server's point.
        request_queue_size = 128

    try:
        server = Server((host, port), Handler)
    except OSError:
        batcher.stop()                 # don't leak the dispatcher thread
        raise
    return server, batcher


def main(argv=None) -> None:
    """``python -m neurovit_tpu_torch.serving_http``: online prediction
    server."""
    import argparse

    from neurovit_tpu_torch.config import load_config

    parser = argparse.ArgumentParser(
        description="NeuroViT HTTP prediction server (PyTorch / CUDA)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--batch-size", type=int, default=None,
                        help="largest coalesced batch (default 128; 2 "
                             "sequences for a 4D checkpoint)")
    parser.add_argument("--window", type=float, default=0.005,
                        help="micro-batch coalescing window in seconds")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip running every bucket at startup")
    add_serving_args(parser)
    args = parser.parse_args(argv)

    config = load_config(args.config)
    predictor = predictor_from_cli_args(parser, args, config)
    if not args.no_warmup:
        print(f"Warming buckets {predictor.bucket_sizes} ...")
        predictor.warmup()
    server, batcher = make_server(predictor, host=args.host, port=args.port,
                                  window=args.window)
    print(f"Serving on http://{args.host}:{server.server_address[1]} "
          f"(buckets {predictor.bucket_sizes}, "
          f"window {args.window * 1e3:.1f} ms)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        batcher.stop()


if __name__ == "__main__":
    main()
