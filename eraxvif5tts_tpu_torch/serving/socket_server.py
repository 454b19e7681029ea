"""Raw-TCP streaming TTS server on the port's wrapper (port of
`eraxvif5tts_tpu/serving/socket_server.py`).

Protocol, as in the reference server: the client sends UTF-8 text; the
server streams raw float32 PCM frames and a final ``b"END"``. The first
request's first chunk is re-split down to ``few_chars`` then ``min_chars``
so the first audio arrives early; a warm-up generation runs at start-up;
a writer thread can persist each response as a wav.

:func:`start_server` serves until its ``stop`` event is set, then joins the
client threads it started, so a caller (or a test) can shut it down cleanly.

    python -m eraxvif5tts_tpu_torch.serving.socket_server --ckpt_file ... \
        --vocab_file ... --ref_audio ref.wav --ref_text "..."
    python -m eraxvif5tts_tpu_torch.serving.socket_server --smoke --device cpu
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import traceback
from typing import Callable, Optional

import numpy as np

from eraxvif5tts_tpu_torch.audio.io import write_wav
from eraxvif5tts_tpu_torch.text.chunk import chunk_text
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper, ReferenceState


class AudioFileWriterThread(threading.Thread):
    """Queue-drained wav writer."""

    def __init__(self, output_file: str, sample_rate: int):
        super().__init__(daemon=True)
        self.output_file = output_file
        self.sample_rate = sample_rate
        self.queue: queue.Queue = queue.Queue()
        self.stop_event = threading.Event()
        self.chunks: list[np.ndarray] = []

    def run(self):
        while not self.stop_event.is_set() or not self.queue.empty():
            try:
                self.chunks.append(np.asarray(self.queue.get(timeout=0.1), np.float32))
            except queue.Empty:
                continue
        if self.chunks:
            write_wav(self.output_file, np.concatenate(self.chunks), self.sample_rate)

    def add_chunk(self, chunk):
        self.queue.put(chunk)

    def stop(self):
        self.stop_event.set()
        self.join()


class TTSStreamingProcessor:
    """Holds the wrapper + reference and streams float32 chunks per request.
    Requests are served one at a time (``generate_stream`` holds a lock), as
    the first-package state and the writer thread are per processor."""

    def __init__(self, wrapper: F5TTSWrapper, ref_audio: Optional[str] = None,
                 ref_text: str = "", ref_state: Optional[ReferenceState] = None,
                 chunk_size: int = 2048, output_file: Optional[str] = "output.wav",
                 nfe_step: Optional[int] = None, warm_up: bool = True):
        self.wrapper = wrapper
        self.chunk_size = chunk_size
        self.output_file = output_file
        self.nfe_step = nfe_step
        self.ref = ref_state if ref_state is not None else wrapper.preprocess_reference(
            ref_audio, ref_text)
        self.sampling_rate = wrapper.target_sample_rate
        self._update_char_budgets()
        self.file_writer_thread: Optional[AudioFileWriterThread] = None
        self.first_package = True
        self._lock = threading.Lock()
        if warm_up:
            self.wrapper.generate("Warm-up text for the model.", ref=self.ref,
                                  nfe_step=self.nfe_step, return_numpy=True)

    def _update_char_budgets(self):
        """First-package budgets from the reference's byte/second ratio."""
        ref_sec = max(self.ref.audio_seconds, 1e-3)
        ref_bytes = max(len(self.ref.text.encode("utf-8")), 1)
        base = ref_bytes / ref_sec * max(25.0 - ref_sec, 1.0)
        self.max_chars = max(int(base), 8)
        self.few_chars = max(int(base / 2), 4)
        self.min_chars = max(int(base / 4), 2)

    def generate_stream(self, text: str, send: Callable[[bytes], object]):
        """Synthesise ``text``; call ``send(bytes)`` per float32 chunk, then END."""
        with self._lock:
            batches = chunk_text(text, max_chars=self.max_chars)
            if self.first_package and batches:
                batches = chunk_text(batches[0], max_chars=self.few_chars) + batches[1:]
                batches = chunk_text(batches[0], max_chars=self.min_chars) + batches[1:]
                self.first_package = False
            if self.output_file:
                self.file_writer_thread = AudioFileWriterThread(self.output_file,
                                                                self.sampling_rate)
                self.file_writer_thread.start()
            try:
                for batch in batches:
                    wave = self.wrapper.generate(batch, ref=self.ref, nfe_step=self.nfe_step,
                                                 return_numpy=True)
                    for j in range(0, len(wave), self.chunk_size):
                        piece = wave[j: j + self.chunk_size]
                        send(struct.pack(f"{len(piece)}f", *piece.tolist()))
                        if self.file_writer_thread is not None:
                            self.file_writer_thread.add_chunk(piece)
                send(b"END")
            finally:
                if self.file_writer_thread is not None:
                    self.file_writer_thread.stop()
                    self.file_writer_thread = None


def handle_client(conn: socket.socket, processor: TTSStreamingProcessor):
    """Serve one connection: each received message is one request. A failing
    request is reported on stderr and closes the connection."""
    try:
        with conn:
            while True:
                data = conn.recv(1024)
                if not data:
                    break
                text = data.decode("utf-8").strip()
                if text:
                    processor.generate_stream(text, conn.sendall)
    except Exception:  # boundary: one bad connection must not stop the server
        traceback.print_exc()


def start_server(host: str, port: int, processor: TTSStreamingProcessor,
                 stop: Optional[threading.Event] = None,
                 ready: Optional[threading.Event] = None):
    """Accept connections until ``stop`` is set (forever when None), one
    thread per client; then join the client threads."""
    clients: list[threading.Thread] = []
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen()
        s.settimeout(0.2)
        print(f"socket TTS server listening on {host}:{port}", flush=True)
        if ready is not None:
            ready.set()
        while stop is None or not stop.is_set():
            try:
                conn, _ = s.accept()
            except socket.timeout:
                continue
            conn.settimeout(None)
            thread = threading.Thread(target=handle_client, args=(conn, processor),
                                      daemon=True)
            thread.start()
            clients.append(thread)
            clients = [t for t in clients if t.is_alive()]
    for thread in clients:
        thread.join()


def smoke_wrapper(device: str = "cpu") -> tuple[F5TTSWrapper, ReferenceState]:
    """A tiny randomly initialised wrapper and a synthetic 0.5 s reference."""
    from eraxvif5tts_tpu_torch.configs import ArchConfig, ModelConfig

    cfg = ModelConfig(arch=ArchConfig(dim=128, depth=2, heads=2, dim_head=64,
                                      text_dim=32, conv_layers=1, dropout=0.0))
    vocab = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?-")}
    wrapper = F5TTSWrapper(model_cfg=cfg, vocab_char_map=vocab, nfe_step=4,
                           duration_buckets=(128, 256), text_buckets=(128,),
                           device=device,
                           compute_dtype="bfloat16" if device != "cpu" else "float32")
    t = np.arange(24000 // 2) / 24000.0
    wav = (0.2 * np.sin(2 * np.pi * 150 * t)).astype(np.float32)
    state = wrapper.preprocess_reference(ref_audio=wav, ref_sample_rate=24000,
                                         ref_text="xin chao cac ban")
    return wrapper, state


def main(argv: Optional[list[str]] = None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9998)
    ap.add_argument("--ckpt_file", default=None)
    ap.add_argument("--vocab_file", default=None)
    ap.add_argument("--vocoder_ckpt", default=None)
    ap.add_argument("--ref_audio", default=None)
    ap.add_argument("--ref_text", default="")
    ap.add_argument("--model", default="F5TTS_v1_Base")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny random model and a synthetic reference")
    args = ap.parse_args(argv)

    if args.smoke:
        wrapper, state = smoke_wrapper(args.device)
        processor = TTSStreamingProcessor(wrapper, ref_state=state, nfe_step=4,
                                          output_file=None)
    else:
        wrapper = F5TTSWrapper(model_name=args.model, ckpt_path=args.ckpt_file,
                               vocab_file=args.vocab_file,
                               vocoder_ckpt_path=args.vocoder_ckpt, device=args.device)
        processor = TTSStreamingProcessor(wrapper, ref_audio=args.ref_audio,
                                          ref_text=args.ref_text)
    start_server(args.host, args.port, processor)


if __name__ == "__main__":
    main()
