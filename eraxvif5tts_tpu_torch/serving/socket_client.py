"""Asyncio TCP streaming client with first-chunk latency measurement (the
port's copy of `eraxvif5tts_tpu/serving/socket_client.py`, for the port's
socket server).

Parity with reference `src/f5_tts/socket_client.py:12-55`; pyaudio playback is
optional (gated import) — without it the client collects chunks and reports timing.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

try:  # optional playback
    import pyaudio

    _HAS_PYAUDIO = True
except ImportError:  # pragma: no cover
    _HAS_PYAUDIO = False


async def listen_to_f5tts(
    text: str,
    server_ip: str = "localhost",
    server_port: int = 9998,
    sample_rate: int = 24000,
    play: bool = True,
) -> tuple[np.ndarray, float | None]:
    """Send ``text``; returns (waveform, first_chunk_latency_seconds)."""
    reader, writer = await asyncio.open_connection(server_ip, server_port)
    start = time.time()
    writer.write(text.encode("utf-8"))
    await writer.drain()

    first_chunk_time = None
    buffer = b""
    stream = None
    audio = None
    if play and _HAS_PYAUDIO:
        audio = pyaudio.PyAudio()
        stream = audio.open(format=pyaudio.paFloat32, channels=1, rate=sample_rate,
                            output=True)
    chunks: list[np.ndarray] = []
    try:
        while True:
            data = await reader.read(4096)
            if not data:
                break
            buffer += data
            if buffer.endswith(b"END"):
                buffer = buffer[:-3]
                if buffer:
                    chunk = np.frombuffer(buffer, dtype=np.float32)
                    chunks.append(chunk)
                    if stream is not None:
                        stream.write(chunk.tobytes())
                break
            # drain whole float32 frames, keep the remainder
            n_floats = len(buffer) // 4
            if n_floats:
                chunk = np.frombuffer(buffer[: n_floats * 4], dtype=np.float32)
                buffer = buffer[n_floats * 4:]
                if first_chunk_time is None:
                    first_chunk_time = time.time() - start
                    print(f"first audio chunk after {first_chunk_time*1000:.0f} ms")
                chunks.append(chunk)
                if stream is not None:
                    stream.write(chunk.tobytes())
    finally:
        if stream is not None:
            stream.stop_stream()
            stream.close()
            audio.terminate()
        writer.close()
        await writer.wait_closed()

    wave = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    return wave, first_chunk_time


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("text", nargs="?", default="Xin chào, đây là bài kiểm tra.")
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=9998)
    ap.add_argument("--no-play", action="store_true")
    args = ap.parse_args()
    wave, latency = asyncio.run(
        listen_to_f5tts(args.text, args.host, args.port, play=not args.no_play)
    )
    print(f"received {len(wave)} samples ({len(wave)/24000:.2f}s), "
          f"first chunk {latency and round(latency*1000)} ms")


if __name__ == "__main__":
    main()
