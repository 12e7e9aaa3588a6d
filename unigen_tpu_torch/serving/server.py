"""HTTP front end for the continuous-batching engine.

Port of ``unigen_tpu/serving/server.py``. Standard library only: a
``ThreadingHTTPServer`` whose handler threads block on the engine's futures
while the engine's one scheduler thread drives the device.

Endpoints:
  GET  /healthz              -> {"status": "ok", "stats": {...}}; 503 "dead"
                                once the engine's scheduler has exited
  POST /v1/generate          -> body {"prompt_ids": [...]} or {"prompt": "text"}
                                (+ optional "max_new_tokens", "temperature",
                                "eot_token", "seed", "raw", "stream"); returns
                                {"tokens": [...]} and, with a tokenizer,
                                {"text": "..."}; "stream": true answers with
                                server-sent events, one a token burst.
  POST /v1/images            -> body {"prompt": "text"}; returns
                                {"image_png": base64, "width", "height"} from an
                                ``ImageServingEngine`` (``image_engine``); the
                                PNG comes from ``evaluation.geneval.png_bytes``.
  POST /v1/completions       -> OpenAI-compatible text completion
  POST /v1/chat/completions  -> OpenAI-compatible chat completion (ChatML
                                assembly); both need a tokenizer.
"""
from __future__ import annotations

import base64
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ..evaluation.geneval import png_bytes
from .engine import ServingEngine


class ServingHTTPServer:
    """Wraps a ServingEngine behind HTTP. ``port=0`` picks a free port.

    ``tokenizer`` (optional): any object with ``encode(str) -> list[int]``
    and ``decode(list[int]) -> str``, which enables ``{"prompt": "text"}``
    and the OpenAI routes; without it only ``prompt_ids`` is accepted.
    """

    def __init__(self, engine: ServingEngine, *, host: str = "127.0.0.1",
                 port: int = 0, tokenizer: Any = None,
                 default_max_new_tokens: int = 128,
                 default_eot_token: Optional[int] = None,
                 request_timeout: float = 600.0, image_engine: Any = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.image_engine = image_engine
        self.default_eot_token = default_eot_token
        self.default_max_new_tokens = default_max_new_tokens
        self.request_timeout = request_timeout
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    s = outer.engine.stats
                    alive = outer.engine.healthy
                    self._reply(200 if alive else 503, {
                        "status": "ok" if alive else "dead",
                        "stats": {
                            "requests_completed": s.requests_completed,
                            "tokens_generated": s.tokens_generated,
                            "decode_chunks": s.decode_chunks,
                            "occupancy": round(s.occupancy, 4)}})
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            ROUTES = ("/v1/generate", "/v1/images", "/v1/completions",
                      "/v1/chat/completions")

            def do_POST(self):
                if self.path not in self.ROUTES:
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/v1/images":
                        self._reply(200, outer._image(req))
                    elif self.path == "/v1/completions":
                        self._reply(200, outer._openai(req, chat=False))
                    elif self.path == "/v1/chat/completions":
                        self._reply(200, outer._openai(req, chat=True))
                    elif req.get("stream"):
                        self._stream(req)
                    else:
                        self._reply(200, outer._generate(req))
                except (ValueError, KeyError, TypeError) as e:
                    self._reply(400, {"error": str(e)})
                except TimeoutError as e:
                    self._reply(504, {"error": str(e)})
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client gone; nothing to reply to
                except Exception as e:  # engine death etc.: a JSON 500, not a dropped socket
                    traceback.print_exc()
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def _stream(self, req: Dict[str, Any]) -> None:
                """Server-sent events: one ``data:`` line a token, then a final
                event with the assembled result."""
                fut = outer._submit(req)   # validation errors -> 400, before the headers
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    tokens = []
                    for tok in fut.stream(timeout=outer.request_timeout):
                        tokens.append(tok)
                        self.wfile.write(f"data: {json.dumps({'token': tok})}\n\n".encode())
                        self.wfile.flush()
                    final: Dict[str, Any] = {"done": True, "tokens": tokens,
                                             "request_id": fut.request_id}
                    if outer.tokenizer is not None:
                        final["text"] = outer.tokenizer.decode(tokens)
                    self.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    # the client went away: free the slot instead of decoding
                    # the rest of the budget for nobody
                    fut.cancel()
                except Exception as e:
                    # the headers are on the wire, so a status line would
                    # corrupt the stream: a terminal error event, and free the slot
                    fut.cancel()
                    try:
                        self.wfile.write(
                            f"data: {json.dumps({'done': True, 'error': str(e)})}\n\n".encode())
                        self.wfile.flush()
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="unigen-http")

    def _submit(self, req: Dict[str, Any]):
        if "prompt_ids" in req:
            ids = [int(t) for t in req["prompt_ids"]]
        elif "prompt" in req:
            if self.tokenizer is None:
                raise ValueError("server has no tokenizer; send prompt_ids")
            enc = self.tokenizer.encode
            if req.get("raw"):  # skip any template the tokenizer shim applies
                enc = getattr(self.tokenizer, "encode_raw", enc)
            ids = list(enc(str(req["prompt"])))
        else:
            raise ValueError("body must contain prompt_ids or prompt")
        if not ids:
            raise ValueError("prompt must contain at least one token")
        eot = req.get("eot_token", self.default_eot_token)
        return self.engine.submit(
            ids,
            max_new_tokens=int(req.get("max_new_tokens") or self.default_max_new_tokens),
            temperature=float(req.get("temperature") or 0.0),
            eot_token=(int(eot) if eot is not None else None),
            seed=(int(req["seed"]) if req.get("seed") is not None else None))

    def _image(self, req: Dict[str, Any]) -> Dict[str, Any]:
        if self.image_engine is None:
            raise ValueError("server was built without an image engine")
        if "prompt" not in req:
            raise ValueError("body must contain prompt")
        fut = self.image_engine.submit(str(req["prompt"]))
        image = fut.result(timeout=self.request_timeout)
        return {"image_png": base64.b64encode(png_bytes(image)).decode("ascii"),
                "width": int(image.shape[1]), "height": int(image.shape[0]),
                "request_id": fut.request_id}

    def _openai(self, req: Dict[str, Any], *, chat: bool) -> Dict[str, Any]:
        """OpenAI-compatible /v1/completions and /v1/chat/completions.

        ``max_tokens``, ``temperature``, ``seed`` and ``stop`` map onto the
        engine request; chat messages are assembled into the Qwen ChatML
        template. Streaming and n > 1 are not supported here (/v1/generate
        streams). Stop strings are applied on the host after decoding."""
        if self.tokenizer is None:
            raise ValueError("server has no tokenizer; OpenAI routes need one")
        if req.get("stream"):
            raise ValueError("stream is not supported on the OpenAI routes; "
                             "use /v1/generate with stream=true")
        if int(req.get("n", 1)) != 1:
            raise ValueError("n > 1 is not supported")
        if chat:
            parts = []
            for m in req.get("messages") or []:
                content = m["content"]
                if isinstance(content, list):  # OpenAI content-parts form
                    texts = []
                    for part in content:
                        if not isinstance(part, dict) or part.get("type") != "text":
                            raise ValueError("only text content parts are supported")
                        texts.append(part["text"])
                    content = "".join(texts)
                parts.append(f"<|im_start|>{m['role']}\n{content}<|im_end|>\n")
            if not parts:
                raise ValueError("messages must be a non-empty list")
            prompt = "".join(parts) + "<|im_start|>assistant\n"
            enc = getattr(self.tokenizer, "encode_raw", self.tokenizer.encode)
            ids = list(enc(prompt))
        else:
            if "prompt" not in req:
                raise ValueError("body must contain prompt")
            ids = list(self.tokenizer.encode(str(req["prompt"])))
        # `or` chains tolerate explicit nulls, which OpenAI clients send
        max_new = int(req.get("max_tokens") or req.get("max_new_tokens")
                      or self.default_max_new_tokens)
        sub = {"prompt_ids": ids, "max_new_tokens": max_new,
               "temperature": float(req.get("temperature") or 0.0)}
        if req.get("seed") is not None:
            sub["seed"] = int(req["seed"])
        if req.get("eot_token") is not None:
            sub["eot_token"] = int(req["eot_token"])
        fut = self._submit(sub)
        tokens = fut.result(timeout=self.request_timeout)
        text = self.tokenizer.decode(tokens)
        finish = "length" if len(tokens) >= max_new else "stop"
        stops = req.get("stop") or []
        if isinstance(stops, str):
            stops = [stops]
        for s in stops:
            if s and s in text:
                text, finish = text.split(s)[0], "stop"
        usage = {"prompt_tokens": len(ids), "completion_tokens": len(tokens),
                 "total_tokens": len(ids) + len(tokens)}
        if chat:
            return {"id": f"chatcmpl-{fut.request_id}", "object": "chat.completion",
                    "model": "unigen-tpu", "choices": [{
                        "index": 0, "finish_reason": finish,
                        "message": {"role": "assistant", "content": text}}],
                    "usage": usage}
        return {"id": f"cmpl-{fut.request_id}", "object": "text_completion", "model": "unigen-tpu",
                "choices": [{"index": 0, "text": text, "finish_reason": finish}],
                "usage": usage}

    def _generate(self, req: Dict[str, Any]) -> Dict[str, Any]:
        fut = self._submit(req)
        tokens = fut.result(timeout=self.request_timeout)
        out: Dict[str, Any] = {"tokens": tokens, "request_id": fut.request_id}
        if self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(tokens)
        return out

    def start(self) -> "ServingHTTPServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)

    def __enter__(self) -> "ServingHTTPServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()
