"""HTTP front end for the online continuous OCR engine (standard library
only; port of deepseek_ocr2_tpu.runtime.http_server).

Requests POST an image and wait on its `OCRRequest` while the engine batches
them continuously with whatever else is in flight.

Endpoints:
- POST /v1/ocr   body = image bytes (PNG, JPEG, ...); query parameters
                 prompt, max_new_tokens, no_crop, rotate, auto_rotate,
                 timeout (seconds). 200 -> JSON result; 400 bad image or
                 arguments; 504 timeout.
                 With `stream=1`: Server-Sent Events, one
                 `data: {"text_delta": ..., "n_tokens": ...}` event per
                 decode chunk (plus `token_ids` when the server was built
                 with include_token_ids), then a final
                 `data: {"done": true, ...result...}` event. Errors after
                 the stream opened arrive as `data: {"error": ...}`.
- GET  /healthz  liveness.
- GET  /v1/stats engine and serving counters.

Threading: `ThreadingHTTPServer` gives each connection a handler thread;
handlers only enqueue work and wait on futures, so slow clients never block
the engine's serve thread. PIL is imported inside the handler.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .continuous import ContinuousOCREngine, _TextStream

DEFAULT_TIMEOUT = 600.0  # seconds a request waits for its page unless it passes ?timeout=


def _bool_arg(q, name: str, default: bool = False) -> bool:
    v = q.get(name, [None])[0]
    if v is None:
        return default
    return v.lower() not in ("0", "false", "no", "")


class OCRHttpServer:
    """Serve an already-started online ContinuousOCREngine over HTTP."""

    def __init__(
        self,
        engine: ContinuousOCREngine,
        host: str = "127.0.0.1",
        port: int = 8000,
        include_token_ids: bool = False,
    ):
        self.engine = engine
        self.include_token_ids = include_token_ids
        self.n_requests = 0
        self.n_errors = 0
        self._count_lock = threading.Lock()
        self.started = time.time()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet by default
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, msg: str):
                outer._count(error=True)
                return self._json(code, {"error": msg})

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    return self._json(200, {"status": "ok"})
                if path == "/v1/stats":
                    return self._json(200, outer.stats())
                return self._json(404, {"error": "not found"})

            def do_POST(self):
                from PIL import Image

                url = urlparse(self.path)
                if url.path != "/v1/ocr":
                    return self._json(404, {"error": "not found"})
                try:
                    raw = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                    q = parse_qs(url.query)
                    image = Image.open(io.BytesIO(raw))
                    image.load()  # decode now, so bad bytes are a 400 here
                    kwargs = dict(
                        prompt=q.get("prompt", [None])[0],
                        max_new_tokens=int(q.get("max_new_tokens", ["512"])[0]),
                        no_crop=_bool_arg(q, "no_crop"),
                        rotate=int(q.get("rotate", ["0"])[0]),
                        auto_rotate=_bool_arg(q, "auto_rotate"),
                    )
                    timeout = float(q.get("timeout", [str(DEFAULT_TIMEOUT)])[0])
                    stream = _bool_arg(q, "stream")
                except Exception as e:  # any unreadable body or argument is the client's error
                    return self._error(400, f"bad request: {e}")
                if stream:
                    return self._stream_ocr(image, kwargs, timeout)
                try:
                    res = outer.engine.submit(image, **kwargs).result(timeout=timeout)
                except TimeoutError:
                    return self._error(504, "generation timed out")
                except ValueError as e:  # per-request validation: bad prompt, budget over capacity
                    return self._error(400, str(e))
                except Exception as e:
                    return self._error(500, str(e))
                outer._count(error=False)
                return self._json(200, outer._result_json(res))

            def _stream_ocr(self, image, kwargs, timeout):
                """SSE: one event per decode chunk, then a final done event.
                No Content-Length: the connection closes at the end of the
                stream (Connection: close keeps HTTP/1.1 framing valid)."""
                try:
                    fut = outer.engine.submit(image, stream=True, **kwargs)
                except ValueError as e:
                    return self._error(400, str(e))
                except Exception as e:
                    return self._error(500, str(e))
                # Pull the first chunk before committing to SSE, so that
                # admission failures still map to HTTP status codes.
                gen = fut.stream_token_ids(timeout=timeout)
                first = None
                try:
                    first = next(gen)
                except StopIteration:
                    pass  # finished without a streamed chunk
                except TimeoutError:
                    return self._error(504, "generation timed out")
                except ValueError as e:
                    return self._error(400, str(e))
                except Exception as e:
                    return self._error(500, str(e))
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()

                def sse(obj):
                    self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
                    self.wfile.flush()

                pipe = outer.engine.pipe
                ts = _TextStream(pipe.tokenizer, pipe.cfg.stop_string)
                deadline = time.time() + timeout

                def emit(ids):
                    ev = {"text_delta": ts.push(ids), "n_tokens": len(ids)}
                    if outer.include_token_ids:
                        ev["token_ids"] = ids
                    sse(ev)

                try:
                    if first is not None:
                        emit(first)
                    for ids in gen:
                        emit(ids)
                    res = fut.result(timeout=max(0.0, deadline - time.time()))
                except TimeoutError:
                    outer._count(error=True)
                    return self._try_sse(sse, {"error": "generation timed out"})
                except OSError:
                    # The client went away; the engine finishes the page anyway.
                    outer._count(error=True)
                    return
                except Exception as e:
                    outer._count(error=True)
                    return self._try_sse(sse, {"error": str(e)})
                outer._count(error=False)
                out = outer._result_json(res)
                out.pop("token_ids", None)
                self._try_sse(sse, {"done": True, **out})

            @staticmethod
            def _try_sse(sse, obj):
                try:
                    sse(obj)
                except OSError:
                    pass  # client already gone

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _count(self, error: bool) -> None:
        with self._count_lock:  # handler threads update the counters concurrently
            if error:
                self.n_errors += 1
            else:
                self.n_requests += 1

    def _result_json(self, res) -> dict:
        out = {
            "text": res.text,
            "new_tokens": res.new_tokens,
            "prompt_len": res.prompt_len,
            "prefill_seconds": res.prefill_seconds,
            "decode_seconds": res.decode_seconds,
        }
        if self.include_token_ids:
            out["token_ids"] = res.token_ids
        return out

    def stats(self) -> dict:
        e = self.engine
        return {
            "requests": self.n_requests,
            "errors": self.n_errors,
            "uptime_seconds": time.time() - self.started,
            "slots": e.slots,
            "pool_tokens": e.pool_tokens,
            "page_size": e.page_size,
            "preempted": e.last_preempted,
        }

    def start_background(self):
        """Serve on a daemon thread (tests, embedding)."""
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
