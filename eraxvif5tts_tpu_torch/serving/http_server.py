"""Streaming TTS HTTP server on stdlib asyncio, serving the port's
:class:`~eraxvif5tts_tpu_torch.infer.wrapper.F5TTSWrapper` (port of
`eraxvif5tts_tpu/serving/http_server.py`; endpoint parity with the reference
FastAPI server `src/streaming/f5tts-fastapi-server.py`):

- ``POST /tts/stream``  JSON {text, reference_id | speaker, nfe_step?,
  cfg_strength?, speed?, sway_sampling_coef?, seed?, cross_fade_duration?}
  -> chunked ``audio/wav`` stream: the WAV header first, then int16 PCM per
  text chunk;
- ``POST /upload_reference`` multipart (file=<wav>, ref_text=<str>,
  reference_id?) -> 202, processed in the background behind a "processing"
  placeholder;
- ``GET /references``, ``GET /health``, ``GET /`` (the streaming client page,
  `client.html` beside this file).

Each request resolves an immutable ``ReferenceState`` and passes it to
``wrapper.generate(ref=...)``; nothing of the wrapper is mutated per request.
Hardening as in the JAX server: 413 on an oversize body before buffering it,
a read timeout, a per-chunk ``generation_timeout``, and at most
``max_concurrent_generations`` (4) generations in flight, each in a worker
thread (``asyncio.to_thread``) calling the one wrapper: the host caches and
launch counters on the kernels' path take locks for that
(`ops/serving_attention.py`, `ops/_cuda.py`). A failing chunk is logged and
skipped; the stream goes on.

:meth:`TTSServer.serve` ends cleanly when its task is cancelled: the
listening socket closes, open connections and background reference jobs are
cancelled. :class:`ServerThread` runs it on an event loop of its own in a
thread and stops it with no thread left.

    python -m eraxvif5tts_tpu_torch.serving.http_server --ckpt model.pt \
        --vocab vocab.txt --ref-audio ref.wav --ref-text "..."
    python -m eraxvif5tts_tpu_torch.serving.http_server --smoke --device cpu
"""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper, ReferenceState
from eraxvif5tts_tpu_torch.serving.wave_stream import create_wave_header, float_to_int16_bytes
from eraxvif5tts_tpu_torch.text.chunk import chunk_text

try:  # optional Vietnamese text normalizer (the reference server uses vinorm)
    from vinorm import TTSnorm as _ttsnorm
except ImportError:  # pragma: no cover
    def _ttsnorm(text: str) -> str:
        return text


@dataclass
class ServerConfig:
    """Parity with the reference config block (`f5tts-fastapi-server.py:23-48`)."""

    host: str = "0.0.0.0"
    port: int = 8000
    model_name: str = "F5TTS_v1_Base"
    ckpt_path: Optional[str] = None
    vocab_file: Optional[str] = None
    vocoder_ckpt_path: Optional[str] = None
    default_references: dict = field(default_factory=dict)  # id -> (wav_path, text)
    text_chunk_size: int = 100
    nfe_step: int = 32
    cfg_strength: float = 2.0
    speed: float = 1.0
    sway_sampling_coef: float = -1.0
    # hardening (the reference FastAPI server has none of these):
    max_body_bytes: int = 50 * 1024 * 1024  # uploads; oversize -> 413, no buffering
    request_read_timeout: float = 30.0  # seconds to receive head+body
    generation_timeout: float = 300.0  # per text-chunk synthesis budget
    max_concurrent_generations: int = 4  # device-work admission control
    warmup: bool = False  # run the duration-bucket ladder once at startup


class TTSServer:
    def __init__(self, wrapper: F5TTSWrapper, config: ServerConfig | None = None):
        self.wrapper = wrapper
        self.config = config or ServerConfig()
        self.references: dict[str, ReferenceState | str] = {}  # id -> state|"processing"
        self._gen_semaphore = asyncio.Semaphore(
            max(self.config.max_concurrent_generations, 1)
        )
        self._tasks: set[asyncio.Task] = set()  # connection handlers, reference jobs
        self.port: Optional[int] = None  # the bound port, once serve() listens

    # ------------------------------------------------------------------

    async def startup(self):
        """Preprocess and cache the default references (`:87-170`)."""
        for ref_id, (path, text) in self.config.default_references.items():
            state = await asyncio.to_thread(
                self.wrapper.preprocess_reference, path, text
            )
            self.references[ref_id] = state
        if self.config.warmup and self.references:
            # build the kernels and run every reachable bucket once before
            # accepting traffic (`F5TTSWrapper.warmup`)
            ref = next(iter(self.references.values()))
            warmed = await asyncio.to_thread(self.wrapper.warmup, ref,
                                             self.config.nfe_step)
            print(f"warmup: ran {len(warmed)} (bucket, text bucket) pairs: {warmed}")

    # ------------------------------------------------------------------
    # HTTP plumbing

    async def serve(self, ready: Optional[threading.Event] = None):
        """Listen until cancelled; ``ready`` is set once the socket listens
        (``self.port`` holds the bound port, for ``port=0``)."""
        server = await asyncio.start_server(self._handle, self.config.host, self.config.port)
        self.port = server.sockets[0].getsockname()[1]
        addrs = ", ".join(str(s.getsockname()) for s in server.sockets)
        print(f"TTS server listening on {addrs}", flush=True)
        if ready is not None:
            ready.set()
        try:
            await server.serve_forever()
        finally:
            # stop accepting, then end the open connections and reference jobs
            # (a generation already in a worker thread runs to its end; the
            # loop's owner waits for it with `shutdown_default_executor`)
            server.close()
            pending = [t for t in self._tasks if not t.done()]
            for task in pending:
                task.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
            await server.wait_closed()

    def _track(self, task: asyncio.Task) -> None:
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._track(asyncio.current_task())
        try:
            try:
                request = await asyncio.wait_for(
                    _read_request(reader, max_body=self.config.max_body_bytes),
                    timeout=self.config.request_read_timeout,
                )
            except asyncio.TimeoutError:
                await _respond_json(writer, 408, {"detail": "request read timeout"})
                return
            except _BodyTooLarge as e:
                await _respond_json(writer, 413, {"detail": str(e)})
                return
            if request is None:
                return
            method, path, headers, body = request
            route = (method, path.split("?")[0])
            if route == ("GET", "/health"):
                await self._health(writer)
            elif route == ("GET", "/references"):
                await self._list_references(writer)
            elif route == ("GET", "/"):
                await _respond(writer, 200, _CLIENT_HTML, content_type="text/html")
            elif route == ("POST", "/tts/stream"):
                await self._tts_stream(writer, body)
            elif route == ("POST", "/upload_reference"):
                await self._upload_reference(writer, headers, body)
            else:
                await _respond_json(writer, 404, {"detail": "not found"})
        except ConnectionError:
            pass
        except Exception:
            traceback.print_exc()
            try:
                await _respond_json(writer, 500, {"detail": "internal error"})
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    # ------------------------------------------------------------------
    # endpoints

    async def _health(self, writer):
        ready = {k: not isinstance(v, str) for k, v in self.references.items()}
        await _respond_json(writer, 200, {
            "status": "healthy",
            "model_loaded": self.wrapper is not None,
            "references": ready,
        })

    async def _list_references(self, writer):
        out = {}
        for k, v in self.references.items():
            if isinstance(v, str):
                out[k] = {"status": "processing"}
            else:
                out[k] = {
                    "status": "ready",
                    "text": v.text,
                    "duration_seconds": round(v.audio_seconds, 3),
                }
        await _respond_json(writer, 200, {"references": out})

    async def _tts_stream(self, writer, body: bytes):
        try:
            req = json.loads(body or b"{}")
        except json.JSONDecodeError:
            await _respond_json(writer, 400, {"detail": "invalid JSON body"})
            return
        text = req.get("text", "")
        if not text.strip():
            await _respond_json(writer, 400, {"detail": "text is required"})
            return
        # `speaker` is the reference client's field name (`client.html:454`);
        # `reference_id` matches the upload response — accept both.
        ref_id = req.get("reference_id", req.get("speaker"))
        ref = None
        if ref_id is not None:
            ref = self.references.get(ref_id)
            if ref is None:
                await _respond_json(writer, 404, {"detail": f"unknown reference {ref_id!r}"})
                return
            if isinstance(ref, str):
                await _respond_json(writer, 409, {"detail": f"reference {ref_id!r} still processing"})
                return
        elif self.wrapper.ref is not None:
            ref = self.wrapper.ref
        else:
            await _respond_json(writer, 400, {"detail": "no reference available"})
            return

        sr = self.wrapper.target_sample_rate
        writer.write(
            b"HTTP/1.1 200 OK\r\ncontent-type: audio/wav\r\n"
            b"transfer-encoding: chunked\r\nconnection: close\r\n\r\n"
        )
        await _write_chunk(writer, create_wave_header(sr))

        normalized = _ttsnorm(text)
        pieces = chunk_text(normalized, max_chars=self.config.text_chunk_size)
        for piece in pieces:
            try:
                # admission control: at most max_concurrent_generations device
                # jobs in flight; each chunk has a hard wall-clock budget.
                async with self._gen_semaphore:
                    wave = await asyncio.wait_for(
                        asyncio.to_thread(
                            self.wrapper.generate,
                            piece,
                            ref=ref,
                            nfe_step=int(req.get("nfe_step", self.config.nfe_step)),
                            cfg_strength=float(
                                req.get("cfg_strength", self.config.cfg_strength)),
                            speed=float(req.get("speed", self.config.speed)),
                            sway_sampling_coef=float(
                                req.get("sway_sampling_coef",
                                        self.config.sway_sampling_coef)
                            ),
                            seed=req.get("seed"),
                            cross_fade_duration=float(
                                req.get("cross_fade_duration", 0.15)),
                            return_numpy=True,
                        ),
                        timeout=self.config.generation_timeout,
                    )
                await _write_chunk(writer, float_to_int16_bytes(wave))
            except ConnectionError:
                raise  # the client is gone: generate no more pieces for it
            except Exception:
                # one bad chunk must not kill the stream (`:251-254`)
                traceback.print_exc()
                continue
        await _write_chunk(writer, b"")  # terminating chunk

    async def _upload_reference(self, writer, headers: dict, body: bytes):
        ctype = headers.get("content-type", "")
        if "multipart/form-data" not in ctype:
            await _respond_json(writer, 400, {"detail": "expected multipart/form-data"})
            return
        try:
            fields = _parse_multipart(ctype, body)
        except ValueError as e:
            await _respond_json(writer, 400, {"detail": str(e)})
            return

        def as_text(value) -> str:
            if value is None:
                return ""
            return value.decode("utf-8") if isinstance(value, bytes) else str(value)

        audio = fields.get("file")
        ref_text = as_text(fields.get("ref_text"))
        ref_id = as_text(fields.get("reference_id")) or f"ref_{int(time.time())}"
        if audio is None:
            await _respond_json(writer, 400, {"detail": "file field required"})
            return

        self.references[ref_id] = "processing"  # placeholder (`:548`)
        self._track(asyncio.get_running_loop().create_task(
            self._process_reference(ref_id, audio, ref_text)))
        await _respond_json(writer, 202, {"reference_id": ref_id, "status": "processing"})

    async def _process_reference(self, ref_id: str, audio_bytes: bytes, ref_text: str):
        path = None
        try:
            with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                f.write(audio_bytes)
                path = f.name
            state = await asyncio.to_thread(
                self.wrapper.preprocess_reference, path, ref_text
            )
            self.references[ref_id] = state
        except asyncio.CancelledError:
            self.references.pop(ref_id, None)
            raise
        except Exception:
            traceback.print_exc()
            self.references.pop(ref_id, None)
        finally:
            if path is not None:
                os.unlink(path)


class ServerThread:
    """A :class:`TTSServer` on an event loop of its own in a thread (tests,
    smoke runs): :meth:`start` returns once it listens, :meth:`stop` cancels
    ``serve()``, waits for the loop's worker threads and closes the loop."""

    def __init__(self, server: TTSServer):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, name="tts-http-server")
        self._ready = threading.Event()
        self._task: Optional[asyncio.Task] = None
        self.error: Optional[BaseException] = None

    def _run(self):
        asyncio.set_event_loop(self.loop)
        try:
            self._task = self.loop.create_task(self.server.serve(self._ready))
            try:
                self.loop.run_until_complete(self._task)
            except asyncio.CancelledError:
                pass
            self.loop.run_until_complete(self.loop.shutdown_default_executor())
        except Exception as e:  # surfaced by start() / stop()
            self.error = e
            self._ready.set()
        finally:
            self.loop.close()

    def start(self, timeout: float = 60.0) -> int:
        """Start the thread; returns the bound port."""
        self.thread.start()
        if not self._ready.wait(timeout) or self.error is not None:
            raise RuntimeError(f"HTTP server did not start: {self.error!r}")
        return self.server.port

    def stop(self, timeout: float = 120.0) -> None:
        """Cancel ``serve()`` and join the thread; raises if it is still alive
        or ended with an error."""
        if self._task is not None and not self.loop.is_closed():
            self.loop.call_soon_threadsafe(self._task.cancel)
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise RuntimeError("HTTP server thread did not stop")
        if self.error is not None:
            raise RuntimeError(f"HTTP server ended with {self.error!r}") from self.error


# ---------------------------------------------------------------------------
# tiny HTTP/1.1 + multipart plumbing


class _BodyTooLarge(Exception):
    pass


async def _read_request(reader, max_body: int = 50 * 1024 * 1024):
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
        return None
    lines = head.decode("latin1").split("\r\n")
    method, path, _ = lines[0].split(" ", 2)
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    body = b""
    try:
        n = int(headers.get("content-length", 0))
    except ValueError:
        n = 0
    if n > max_body:
        # reject before buffering anything — a single request could otherwise
        # exhaust the host's memory
        raise _BodyTooLarge(f"body {n} bytes exceeds limit {max_body}")
    if n:
        body = await reader.readexactly(n)
    return method, path, headers, body


async def _respond(writer, status: int, body, content_type="application/json"):
    if isinstance(body, str):
        body = body.encode("utf-8")
    reason = {200: "OK", 202: "Accepted", 400: "Bad Request", 404: "Not Found",
              408: "Request Timeout", 409: "Conflict", 413: "Payload Too Large",
              500: "Internal Server Error"}.get(status, "OK")
    writer.write(
        f"HTTP/1.1 {status} {reason}\r\ncontent-type: {content_type}\r\n"
        f"content-length: {len(body)}\r\nconnection: close\r\n\r\n".encode()
    )
    writer.write(body)
    await writer.drain()


async def _respond_json(writer, status: int, obj):
    await _respond(writer, status, json.dumps(obj))


async def _write_chunk(writer, data: bytes):
    writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
    await writer.drain()


def _parse_multipart(content_type: str, body: bytes) -> dict[str, bytes | str]:
    """Minimal multipart/form-data parser (file fields -> bytes, text -> str)."""
    boundary = None
    for part in content_type.split(";"):
        part = part.strip()
        if part.startswith("boundary="):
            boundary = part[len("boundary="):].strip('"')
    if not boundary:
        raise ValueError("missing multipart boundary")
    delim = b"--" + boundary.encode()
    fields: dict[str, bytes | str] = {}
    for segment in body.split(delim):
        segment = segment.strip(b"\r\n")
        if not segment or segment == b"--":
            continue
        if b"\r\n\r\n" not in segment:
            continue
        raw_headers, content = segment.split(b"\r\n\r\n", 1)
        name = None
        is_file = False
        for hline in raw_headers.decode("latin1").split("\r\n"):
            if hline.lower().startswith("content-disposition"):
                for item in hline.split(";"):
                    item = item.strip()
                    if item.startswith("name="):
                        name = item[5:].strip('"')
                    if item.startswith("filename="):
                        is_file = True
        if name:
            fields[name] = content if is_file else content.decode("utf-8")
    return fields


def _load_client_html() -> str:
    """The streaming client page (`client.html` beside this module; the
    reference's `src/streaming/client.html` with chunked Web Audio playback)."""
    path = os.path.join(os.path.dirname(__file__), "client.html")
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return ("<!doctype html><html><body><h2>EraXviF5TTS-TPU</h2>"
                "<p>client.html missing from the package; POST /tts/stream "
                "directly.</p></body></html>")


_CLIENT_HTML = _load_client_html()


def main(argv: Optional[list[str]] = None):
    import argparse

    from eraxvif5tts_tpu_torch.infer.utils_infer import compute_dtype_for, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--vocoder-ckpt", default=None)
    ap.add_argument("--model", default="F5TTS_v1_Base")
    ap.add_argument("--ref-audio", default=None)
    ap.add_argument("--ref-text", default="")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:N' or 'cpu'")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny random model and a synthetic reference")
    ap.add_argument("--warmup", action="store_true",
                    help="run every reachable duration bucket once before serving")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    smoke_state = None
    if args.smoke:
        from eraxvif5tts_tpu_torch.serving.socket_server import smoke_wrapper

        wrapper, smoke_state = smoke_wrapper(str(dev))
    else:
        wrapper = F5TTSWrapper(model_name=args.model, ckpt_path=args.ckpt,
                               vocab_file=args.vocab, vocoder_ckpt_path=args.vocoder_ckpt,
                               device=dev, compute_dtype=compute_dtype_for(dev))
    config = ServerConfig(host=args.host, port=args.port, model_name=args.model,
                          warmup=args.warmup)
    server = TTSServer(wrapper, config)

    async def run():
        if args.ref_audio:
            config.default_references["default"] = (args.ref_audio, args.ref_text)
        elif smoke_state is not None:
            server.references["default"] = smoke_state
            wrapper.ref = smoke_state
        await server.startup()
        await server.serve()

    asyncio.run(run())


if __name__ == "__main__":
    main()
