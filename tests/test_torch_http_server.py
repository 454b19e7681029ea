"""PyTorch port, the streaming HTTP server (`serving/http_server.py`) on the
port's tiny wrapper on the CPU: the endpoints and their error paths, the
hardening, concurrent streams without crosstalk, the client page, a clean
shutdown with no thread or exception left, and the streamed int16 PCM
against the JAX server's on the same weights and noise (within 4 LSB, as
`tests/test_torch_slice.py`'s PCM_LSB).

Also kernel 1's host caches (`ops/serving_attention.py` `rope_tables`,
`_full_lens`) called from several threads at once, as the server's worker
threads call them on the card.
"""

import asyncio
import http.client
import io
import json
import socket
import sys
import threading
import time
import wave as wave_mod

import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.serving import http_server as jhttp
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.ops import serving_attention as sa
from eraxvif5tts_tpu_torch.serving.http_server import ServerConfig, ServerThread, TTSServer
from eraxvif5tts_tpu_torch.serving.wave_stream import float_to_int16_bytes
from eraxvif5tts_tpu_torch.text.chunk import chunk_text
from test_torch_porcelain import jax_noise, tiny_wrappers
from test_torch_slice import PCM_LSB, REF_TEXT, SR, _ref_audio

HEADER = 44


@pytest.fixture(scope="module")
def wrappers():
    jw, tw = tiny_wrappers()
    jref = jw.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                   ref_text=REF_TEXT)
    tref = tw.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                   ref_text=REF_TEXT)
    return jw, jref, tw, tref


@pytest.fixture(scope="module")
def served(wrappers):
    """The port's server on a free port, in its own loop and thread; stopped
    at the end of the module with every thread joined and no error logged."""
    _, _, tw, tref = wrappers
    errors = []
    server = TTSServer(tw, ServerConfig(host="127.0.0.1", port=0, nfe_step=2))
    server.references["default"] = tref
    runner = ServerThread(server)
    runner.loop.set_exception_handler(lambda loop, ctx: errors.append(ctx))
    port = runner.start()
    yield port, server, errors
    runner.stop()
    assert errors == []


def _post(port, path, body, headers=None, timeout=300):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, body=body,
                 headers=headers or {"content-type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read()


def _stream(port, **req):
    req.setdefault("nfe_step", 2)
    req.setdefault("seed", 0)
    status, data = _post(port, "/tts/stream", json.dumps(req))
    assert status == 200, data
    return data


def _multipart(fields: dict, boundary: str = "x123") -> tuple[bytes, dict]:
    body = b""
    for name, value in fields.items():
        if isinstance(value, bytes):
            body += (f'--{boundary}\r\ncontent-disposition: form-data; name="{name}"; '
                     f'filename="a.wav"\r\ncontent-type: audio/wav\r\n\r\n').encode()
            body += value + b"\r\n"
        else:
            body += (f'--{boundary}\r\ncontent-disposition: form-data; name="{name}"'
                     f"\r\n\r\n{value}\r\n").encode()
    body += f"--{boundary}--\r\n".encode()
    return body, {"content-type": f"multipart/form-data; boundary={boundary}"}


def _wav_bytes(freq: float, seconds: float = 0.5) -> bytes:
    t = np.arange(int(SR * seconds)) / SR
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(SR)
        wf.writeframes((0.2 * np.sin(2 * np.pi * freq * t) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _upload(port, ref_id, freq, text="other ref"):
    body, headers = _multipart({"reference_id": ref_id, "ref_text": text,
                                "file": _wav_bytes(freq)})
    status, _ = _post(port, "/upload_reference", body, headers, timeout=60)
    assert status == 202
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    for _ in range(300):
        conn.request("GET", "/references")
        refs = json.loads(conn.getresponse().read())["references"]
        if refs.get(ref_id, {}).get("status") == "ready":
            return refs[ref_id]
        time.sleep(0.1)
    raise AssertionError(f"reference {ref_id} never became ready: {refs}")


# ---- endpoints -----------------------------------------------------------------


def test_health_and_references(served, wrappers):
    port, _, _ = served
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/health")
    resp = conn.getresponse()
    health = json.loads(resp.read())
    assert resp.status == 200 and health["status"] == "healthy"
    assert health["model_loaded"] and health["references"]["default"] is True
    conn.request("GET", "/references")
    ref = json.loads(conn.getresponse().read())["references"]["default"]
    assert ref["status"] == "ready" and ref["text"].startswith(REF_TEXT)
    assert ref["duration_seconds"] == round(wrappers[3].audio_seconds, 3)


def test_stream_returns_wav(served, wrappers):
    port, _, _ = served
    data = _stream(port, text="hi there.", reference_id="default")
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE" and data[36:40] == b"data"
    channels, rate, bits = np.frombuffer(data[22:24], "<u2")[0], \
        np.frombuffer(data[24:28], "<u4")[0], np.frombuffer(data[34:36], "<u2")[0]
    assert (channels, rate, bits) == (1, SR, 16)
    pcm = np.frombuffer(data[HEADER:], "<i2")
    assert len(pcm) > 1000 and np.abs(pcm).max() > 0


def test_error_paths(served):
    port, server, _ = served
    assert _post(port, "/tts/stream", json.dumps({"text": ""}))[0] == 400
    assert _post(port, "/tts/stream", b"{not json")[0] == 400
    assert _post(port, "/tts/stream", json.dumps({"text": "x", "reference_id": "missing"}))[
        0] == 404
    server.references["busy"] = "processing"
    try:
        status, body = _post(port, "/tts/stream",
                             json.dumps({"text": "x", "reference_id": "busy"}))
        assert status == 409 and b"still processing" in body
    finally:
        del server.references["busy"]
    assert _post(port, "/upload_reference", b"x")[0] == 400  # not multipart
    body, headers = _multipart({"ref_text": "no file"})
    assert _post(port, "/upload_reference", body, headers)[0] == 400
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/nope")
    assert conn.getresponse().status == 404


def test_oversize_body_rejected(served):
    """A content-length beyond max_body_bytes is refused before buffering (413)."""
    port, _, _ = served
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(b"POST /tts/stream HTTP/1.1\r\nhost: x\r\ncontent-type: application/json"
                  b"\r\ncontent-length: 10737418240\r\n\r\n")
        status = s.recv(4096).decode("latin1").split("\r\n")[0]
    assert "413" in status


def test_read_timeout(wrappers):
    """A client that sends no request is answered 408 after the read timeout."""
    _, _, tw, _ = wrappers
    runner = ServerThread(TTSServer(tw, ServerConfig(host="127.0.0.1", port=0,
                                                     request_read_timeout=0.3)))
    port = runner.start()
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            s.sendall(b"GET /health HTTP/1.1\r\n")  # never ends its head
            assert "408" in s.recv(4096).decode("latin1").split("\r\n")[0]
    finally:
        runner.stop()


def test_concurrent_streams_no_crosstalk(served):
    """Parallel /tts/stream requests with different references give exactly the
    audio each gives alone: each request passes its own immutable reference."""
    port, _, _ = served
    _upload(port, "alt", 420.0)
    want = {ref: _stream(port, text="hello there.", reference_id=ref)
            for ref in ("default", "alt")}
    assert want["default"] != want["alt"]
    results = {}

    def worker(key, ref_id):
        results[key] = _stream(port, text="hello there.", reference_id=ref_id)

    threads = [threading.Thread(target=worker, args=(i, ref))
               for i, ref in enumerate(("default", "alt", "default", "alt"))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert [results[i] for i in range(4)] == [want["default"], want["alt"]] * 2


def test_speaker_alias_and_crossfade(served):
    port, _, _ = served
    by_id = _stream(port, text="alias check.", reference_id="default")
    by_alias = _stream(port, text="alias check.", speaker="default")
    assert by_alias == by_id
    faded = _stream(port, text="alias check.", speaker="default", cross_fade_duration=0.05)
    assert faded[:4] == b"RIFF" and len(faded) > HEADER + 1000
    assert _post(port, "/tts/stream", json.dumps({"text": "x", "speaker": "missing"}))[
        0] == 404


def test_bad_chunk_does_not_kill_the_stream(served, monkeypatch):
    """A text chunk whose generation fails is skipped; the others stream."""
    port, server, _ = served
    text = ("The first sentence is long enough to fill most of one chunk on its own here. "
            "This second one fails on purpose, as it should here. The third sentence is "
            "also long enough to need a chunk of its own.")
    generate = server.wrapper.generate

    def flaky(piece, **kw):
        if "fails" in piece:
            raise RuntimeError("chunk failure under test")
        return generate(piece, **kw)

    monkeypatch.setattr(server.wrapper, "generate", flaky)
    data = _stream(port, text=text, reference_id="default")
    pieces = chunk_text(text, max_chars=100)
    assert len(pieces) == 3 and "fails" in pieces[1]
    want = b"".join(float_to_int16_bytes(generate(p, ref=server.references["default"],
                                                  nfe_step=2, seed=0, return_numpy=True))
                    for p in pieces if "fails" not in p)
    assert data[HEADER:] == want


def test_root_serves_the_client(served):
    port, _, _ = served
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/")
    resp = conn.getresponse()
    page = resp.read().decode("utf-8")
    assert resp.status == 200 and resp.getheader("content-type") == "text/html"
    assert "EraXviF5TTS-TPU streaming client" in page
    for endpoint in ("/tts/stream", "/upload_reference", "/references", "/health"):
        assert endpoint in page, endpoint
    assert "getReader" in page and "AudioContext" in page


def test_default_reference_and_startup(wrappers, tmp_path):
    """Default references are preprocessed at startup; a request without an
    id takes the wrapper's current reference, and with none it is a 400."""
    _, _, tw, tref = wrappers
    from eraxvif5tts_tpu_torch.audio.io import write_wav

    path = str(tmp_path / "ref.wav")
    write_wav(path, _ref_audio(), SR)
    server = TTSServer(tw, ServerConfig(host="127.0.0.1", port=0,
                                        default_references={"d": (path, REF_TEXT)}))
    asyncio.run(server.startup())
    assert server.references["d"].n_frames == tref.n_frames
    saved = tw.ref
    tw.ref = None
    runner = ServerThread(server)
    port = runner.start()
    try:
        assert _post(port, "/tts/stream", json.dumps({"text": "x"}))[0] == 400
        tw.ref = server.references["d"]
        assert _stream(port, text="no id.")[:4] == b"RIFF"
    finally:
        tw.ref = saved
        runner.stop()


# ---- against the JAX server ----------------------------------------------------


class _JaxServerThread:
    """The JAX package's server in a loop of its own (its serve() takes no
    readiness event: wait for the socket)."""

    def __init__(self, server):
        self.loop = asyncio.new_event_loop()
        self.server = server
        self.task = None
        self.thread = threading.Thread(target=self._run)

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.task = self.loop.create_task(self.server.serve())
        try:
            self.loop.run_until_complete(self.task)
        except asyncio.CancelledError:
            pass
        self.loop.run_until_complete(self.loop.shutdown_default_executor())
        self.loop.close()

    def start(self, port):
        self.thread.start()
        for _ in range(200):
            try:
                with socket.create_connection(("127.0.0.1", port), timeout=0.2):
                    return
            except OSError:
                time.sleep(0.05)
        raise AssertionError("JAX server did not start")

    def stop(self):
        self.loop.call_soon_threadsafe(self.task.cancel)
        self.thread.join(60)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_stream_pcm_matches_the_jax_server(wrappers, served, monkeypatch):
    jw, jref, _, _ = wrappers
    port, _, _ = served
    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", jax_noise(fold=True))
    jport = _free_port()
    jserver = jhttp.TTSServer(jw, jhttp.ServerConfig(host="127.0.0.1", port=jport,
                                                     nfe_step=2))
    jserver.references["default"] = jref
    runner = _JaxServerThread(jserver)
    runner.start(jport)
    text = ("Tonight the sea was calm, and the lamp turned steadily. Not a single ship "
            "passed the point. Tomorrow the supply boat arrives.")
    try:
        want = [_stream(jport, text=text, reference_id="default", seed=seed)
                for seed in (3, 4)]
    finally:
        runner.stop()
    got = [_stream(port, text=text, reference_id="default", seed=seed) for seed in (3, 4)]
    for g, w in zip(got, want):
        assert g[:HEADER] == w[:HEADER] and len(g) == len(w)
        g16, w16 = (np.frombuffer(x[HEADER:], "<i2").astype(np.int32) for x in (g, w))
        assert np.abs(w16).max() > 1000  # a real signal
        diff = np.abs(g16 - w16).max()
        assert diff <= PCM_LSB, f"PCM differs by {diff} LSB"
    assert got[0] != got[1]


# ---- shutdown and the host caches under threads -------------------------------


def test_shutdown_leaves_no_thread(wrappers, monkeypatch):
    """Cancelling serve() mid-stream ends it: the worker thread finishes its
    generation, the loop closes, no thread or exception is left."""
    _, _, tw, tref = wrappers
    errors = []
    monkeypatch.setattr(threading, "excepthook", lambda args: errors.append(args))
    before = set(threading.enumerate())
    server = TTSServer(tw, ServerConfig(host="127.0.0.1", port=0, nfe_step=2))
    server.references["default"] = tref
    runner = ServerThread(server)
    runner.loop.set_exception_handler(lambda loop, ctx: errors.append(ctx))
    port = runner.start()
    assert _stream(port, text="before shutdown.", reference_id="default")[:4] == b"RIFF"
    long_text = "a long request that is cut by the shutdown. " * 8
    client = threading.Thread(target=lambda: _post(port, "/tts/stream", json.dumps(
        {"text": long_text, "reference_id": "default", "nfe_step": 2})))
    client.start()
    time.sleep(0.3)
    runner.stop()
    client.join(60)
    assert not client.is_alive() and not runner.thread.is_alive()
    assert runner.loop.is_closed()
    assert set(threading.enumerate()) - before == set()
    assert errors == []


def test_kernel1_host_caches_under_threads(monkeypatch):
    """Eight threads take cos / sin tables and full-length vectors through a
    cache of two entries, so entries are evicted between one thread's lookup
    and its use; every result must be right and no call may raise. Before the
    caches took a lock, another thread's eviction between a hit and its
    `move_to_end` raised KeyError here."""
    monkeypatch.setattr(sa, "_CACHE_SIZE", 2)
    monkeypatch.setattr(sa, "_TABLES", type(sa._TABLES)())
    monkeypatch.setattr(sa, "_FULL_LENS", type(sa._FULL_LENS)())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    ropes = [torch.randn(64, 64, generator=torch.Generator().manual_seed(i))
             for i in range(6)]
    errors = []

    def work(i):
        try:
            for j in range(1500):
                rope = ropes[(i + j) % len(ropes)]
                cos, sin = sa.rope_tables(rope)
                assert torch.equal(cos, rope.cos()) and torch.equal(sin, rope.sin())
                b = 1 + (i + j) % 5
                assert torch.equal(sa._full_lens(b, 64, torch.device("cpu")),
                                   torch.full((b,), 64, dtype=torch.int32))
        except Exception as e:  # noqa: BLE001 — collected and reported below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert len(sa._TABLES) <= 2 and len(sa._FULL_LENS) <= 2
