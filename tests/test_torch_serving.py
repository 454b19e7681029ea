"""PyTorch port, serving: the raw-TCP socket server answers requests with
float32 frames ending in END (tiny random model on the CPU) and shuts down
cleanly, with no exception left in any server or client thread."""

import socket
import threading

import numpy as np
import pytest

from eraxvif5tts_tpu_torch.serving.socket_server import (
    TTSStreamingProcessor,
    smoke_wrapper,
    start_server,
)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, text):
    with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
        s.sendall(text.encode("utf-8"))
        buf = b""
        while not buf.endswith(b"END"):
            data = s.recv(65536)
            if not data:
                break
            buf += data
    return buf


def test_socket_server_answers_and_shuts_down(monkeypatch, tmp_path):
    errors = []
    monkeypatch.setattr(threading, "excepthook", lambda args: errors.append(args))
    wrapper, ref = smoke_wrapper("cpu")
    processor = TTSStreamingProcessor(wrapper, ref_state=ref, nfe_step=2,
                                      output_file=str(tmp_path / "out.wav"), warm_up=False)
    port = _free_port()
    stop, ready = threading.Event(), threading.Event()
    server = threading.Thread(target=start_server, args=("127.0.0.1", port, processor),
                              kwargs=dict(stop=stop, ready=ready))
    server.start()
    try:
        assert ready.wait(60)
        for text in ("hello from the port.", "a second request, a bit longer."):
            reply = _request(port, text)
            assert reply.endswith(b"END")
            pcm = reply[:-3]
            assert len(pcm) > 0 and len(pcm) % 4 == 0
            wave = np.frombuffer(pcm, np.float32)
            assert np.isfinite(wave).all() and np.abs(wave).max() > 0
        assert (tmp_path / "out.wav").exists()
    finally:
        stop.set()
        server.join(timeout=60)
    assert not server.is_alive()
    assert errors == []


def test_processor_first_package_is_split_once():
    wrapper, ref = smoke_wrapper("cpu")
    proc = TTSStreamingProcessor(wrapper, ref_state=ref, nfe_step=2, output_file=None,
                                 warm_up=False, chunk_size=512)
    sent: list[bytes] = []
    proc.generate_stream("hello world.", sent.append)
    assert sent[-1] == b"END" and all(len(b) <= 512 * 4 for b in sent[:-1])
    assert proc.first_package is False


def test_preprocess_reference_requires_text():
    # an empty text goes to the transcription backend; with none it fails loudly
    wrapper, _ = smoke_wrapper("cpu")
    with pytest.raises(RuntimeError, match="ref_text"):
        wrapper.preprocess_reference(ref_audio=np.zeros(24000, np.float32), ref_text=" ")
