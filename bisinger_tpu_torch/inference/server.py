"""HTTP serving for the port (counterpart of
`bisinger_tpu/inference/server.py`, the same code but for `main`): a
stdlib `http.server` app that takes scores as JSON, splits long scores
into word-aligned chunks (lyrics + notes + durations together),
synthesizes them through `SVSInferTorch` on the card, and answers WAV.

  GET  /            -> HTML demo page
  GET  /health      -> {"status": "ok"}
  POST /synthesize  -> body {"text", "notes", "notes_duration",
                            "spk_name"?, "bpm"?, "stream"?}
                       response: audio/wav bytes; with "stream": true,
                       chunked-transfer WAV whose PCM arrives chunk by
                       chunk (first audio after the first score chunk)

With `max_batch` > 1 a `MicroBatcher` worker thread owns the device and
puts requests that arrive within `window_ms` of each other through one
`infer_batch`; its queue is bounded (503 with Retry-After beyond it).
Otherwise handler threads take turns under a lock. gradio is optional
(`launch_gradio`). Run it with

    python -m bisinger_tpu_torch.inference.server --ckpt-dir artifacts/flagship \
        --hparams "bucket_tokens=[16,32,64,128],bucket_frames=[256,512,1024,2048]"
"""

from __future__ import annotations

import itertools
import json
import queue
import struct
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

def split_score_chunks(
    inp: Dict[str, Any], max_words: int = 64
) -> List[Dict[str, Any]]:
    """Split a WHOLE score (text + notes + notes_duration, which are
    word-aligned: whitespace words / `|`-separated note groups) into
    consistent chunks — chunking only the lyrics would break the
    frontend's word/notes pairing."""
    words = inp.get("text", "").split()
    notes = [g.strip() for g in inp.get("notes", "").split("|") if g.strip()]
    durs = [g.strip() for g in inp.get("notes_duration", "").split("|") if g.strip()]
    if len(words) <= max_words or len(words) != len(notes) or len(notes) != len(durs):
        # short, or malformed (let the frontend raise its precise error)
        return [inp]
    chunks = []
    for i in range(0, len(words), max_words):
        sl = slice(i, i + max_words)
        chunks.append(
            {
                **inp,
                "text": " ".join(words[sl]),
                "notes": " | ".join(notes[sl]),
                "notes_duration": " | ".join(durs[sl]),
            }
        )
    return chunks


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """float32 [-1,1] -> 16-bit PCM WAV container."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm


def pcm16_bytes(wav: np.ndarray) -> bytes:
    """float32 [-1,1] -> raw 16-bit PCM (no container)."""
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def wav_stream_header(sr: int) -> bytes:
    """WAV header for a stream of unknown length: RIFF/data sizes are
    0xFFFFFFFF, the streaming convention players treat as read-to-EOF."""
    hdr = b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", 0xFFFFFFFF)
    return hdr


_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>BiSinger demo</title></head><body>
<h2>BiSinger &mdash; bilingual singing voice synthesis</h2>
<form id="f">
<p>Lyrics (pinyin / hanzi / English words, AP/SP for breaths):<br>
<input name="text" size="80" value="SP wo xi huan ni circle"></p>
<p>Notes (| separates words):<br>
<input name="notes" size="80" value="rest | C4 | D4 | E4 | F4 | G4 A4"></p>
<p>Note durations (seconds):<br>
<input name="notes_duration" size="80"
 value="0.1 | 0.3 | 0.3 | 0.3 | 0.3 | 0.2 0.2"></p>
<p>Speaker: <input name="spk_name" value=""></p>
<button type="submit">Synthesize</button></form>
<p id="status"></p><audio id="player" controls></audio>
<script>
document.getElementById('f').onsubmit = async (e) => {
  e.preventDefault();
  const data = Object.fromEntries(new FormData(e.target).entries());
  document.getElementById('status').textContent = 'synthesizing...';
  const r = await fetch('/synthesize', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(data)});
  if (!r.ok) {
    document.getElementById('status').textContent = await r.text();
    return;
  }
  const blob = await r.blob();
  document.getElementById('player').src = URL.createObjectURL(blob);
  document.getElementById('status').textContent = 'done';
};
</script></body></html>"""


class QueueFullError(RuntimeError):
    """Admission rejected: the batcher's pending queue is at capacity.

    Mapped to HTTP 503 + Retry-After by the handler — bounded admission
    keeps overload from growing the queue (and every request's latency)
    without limit."""


class MicroBatcher:
    """Cross-request micro-batching for the serving path.

    Requests (or word-aligned chunks of long scores) arriving within
    `window_ms` of each other ride ONE device program via
    `SVSInferTorch.infer_batch`: the batch axis shares the diffusion
    loop's per-step launches among the requests. A single worker thread
    owns the device, so no lock is needed and requests never interleave
    device programs. `batch_sizes` records every group's size.

    Error isolation: if a batched program fails (e.g. one malformed
    score makes the frontend raise), the worker retries each item alone
    so good requests still succeed and only the bad one surfaces its
    error. The reference has no batching server at all (its gradio app
    is single-request, `inference/m4singer/gradio/infer.py`)."""

    def __init__(
        self,
        infer,
        max_batch: int = 8,
        window_ms: float = 25.0,
        max_words: int = 64,
        result_timeout_s: float = 600.0,
        max_queue: int = 128,
    ):
        self.infer = infer
        self.max_batch = max(1, int(max_batch))
        self.window = max(0.0, window_ms) / 1000.0
        self.max_words = max_words
        self.result_timeout_s = result_timeout_s
        # backpressure: max score-CHUNKS admitted but not yet picked up
        # by the worker (0 = unbounded). A multi-chunk score is admitted
        # atomically — all chunks or a QueueFullError, never a partial
        # enqueue that would leave dangling futures.
        self.max_queue = max(0, int(max_queue))
        self._admit_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self.batch_sizes: List[int] = []  # observability: per-program sizes
        self._thread = threading.Thread(
            target=self._loop, name="svs-microbatcher", daemon=True
        )
        self._thread.start()

    # ---- client side ----
    def submit_score(self, inp: Dict[str, Any]) -> np.ndarray:
        """Blocking: chunk a (possibly long) score, submit every chunk to
        the shared batch queue, concatenate the audio."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        chunks = split_score_chunks(inp, max_words=self.max_words)
        futs = [Future() for _ in chunks]
        self._admit(list(zip(chunks, futs)))
        wavs = [f.result(timeout=self.result_timeout_s) for f in futs]
        return wavs[0] if len(wavs) == 1 else np.concatenate(wavs)

    def stream_score(self, inp: Dict[str, Any]):
        """Streaming synthesis: yield each chunk's audio as it finishes,
        in score order.

        Time-to-first-audio optimization for long scores: chunk 0 is
        submitted ALONE and yielded the moment it completes (one small
        device program), and only then are the remaining chunks enqueued
        — otherwise the batcher's coalescing window would fold the whole
        score into one program and the first byte would wait for all of
        it. The tail chunks ride one batched program while chunk 0 is
        already playing (a `max_words`-word chunk plays for tens of
        seconds — far longer than the tail takes to synthesize), so the
        stream never starves. Total wall time is slightly higher than
        `submit_score` (two programs instead of one); first-audio
        latency is ~1/n_chunks of it. The audio is bit-identical to the
        non-streamed path's chunks."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        chunks = split_score_chunks(inp, max_words=self.max_words)
        head = Future()
        # admit the WHOLE score's chunk count up front so a stream that
        # starts always finishes (rejecting tail chunks mid-stream would
        # truncate audio already promised to the client)
        self._admit([(chunks[0], head)], reserve=len(chunks))
        yield head.result(timeout=self.result_timeout_s)
        if len(chunks) == 1:
            return
        futs = [Future() for _ in chunks[1:]]
        for c, f in zip(chunks[1:], futs):
            self._q.put((c, f))
        for f in futs:
            yield f.result(timeout=self.result_timeout_s)

    def _admit(self, items, reserve: int = 0):
        """All-or-nothing admission under the queue bound."""
        need = max(len(items), reserve)
        with self._admit_lock:
            if self.max_queue and self._q.qsize() + need > self.max_queue:
                raise QueueFullError(
                    f"serving queue full ({self._q.qsize()} pending, "
                    f"bound {self.max_queue}); retry later"
                )
            for it in items:
                self._q.put(it)

    # ---- worker side ----
    def _infer_group(self, inps: List[Dict[str, Any]]) -> List[np.ndarray]:
        if hasattr(self.infer, "infer_batch"):
            return self.infer.infer_batch(inps)
        return [self.infer.infer_once(i) for i in inps]

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:  # close sentinel
                return
            group = [item]
            if self.max_batch > 1:
                deadline = time.monotonic() + self.window
                while len(group) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._q.put(None)  # re-arm close after this group
                        break
                    group.append(nxt)
            self.batch_sizes.append(len(group))
            try:
                wavs = self._infer_group([inp for inp, _ in group])
                for (_, fut), wav in zip(group, wavs):
                    fut.set_result(wav)
            except Exception:
                # isolate: one bad score must not poison the batch
                for inp, fut in group:
                    try:
                        fut.set_result(self._infer_group([inp])[0])
                    except Exception as e:
                        fut.set_exception(e)

    def close(self):
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=5)


class SVSRequestHandler(BaseHTTPRequestHandler):
    infer = None  # class attr set by serve()
    batcher: Optional[MicroBatcher] = None  # set by serve()
    sample_rate = 24000
    max_words = 64  # score-chunking granularity, set by serve()
    lock = threading.Lock()  # one device program at a time (no-batcher path)
    # HTTP/1.1 so streaming responses can use chunked transfer encoding
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_stream(self, pieces):
        """Chunked-transfer audio/wav: a streaming WAV header, then each
        synthesized chunk's PCM the moment it is ready."""
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def write_chunk(data: bytes):
            if data:
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                self.wfile.flush()

        write_chunk(wav_stream_header(self.sample_rate))
        for wav in pieces:
            write_chunk(pcm16_bytes(wav))
        self.wfile.write(b"0\r\n\r\n")

    def do_GET(self):
        if self.path == "/health":
            self._send(200, b'{"status": "ok"}', "application/json")
        elif self.path == "/":
            self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        if self.path != "/synthesize":
            self._send(404, b"not found", "text/plain")
            return
        streaming_started = False
        try:
            n = int(self.headers.get("Content-Length", 0))
            inp = json.loads(self.rfile.read(n) or b"{}")
            if inp.pop("stream", False):
                # streaming mode: chunked transfer, first audio after the
                # first score chunk instead of after the whole score
                if self.batcher is not None:
                    pieces = self.batcher.stream_score(inp)
                else:
                    pieces = self._serial_stream(inp)

                def checked(gen):
                    for wav in gen:
                        if wav.ndim != 1:
                            raise ValueError(
                                "no vocoder configured (set vocoder_ckpt)"
                            )
                        yield wav

                gen = checked(pieces)
                # pull the first chunk BEFORE sending headers so an error
                # in it still surfaces as a clean 400 (after the first
                # byte the 200 is committed and errors truncate the
                # chunked stream instead)
                head = list(itertools.islice(gen, 1))
                streaming_started = True
                self._send_stream(itertools.chain(head, gen))
                return
            if self.batcher is not None:
                # concurrent requests ride one device program; the
                # batcher's single worker thread owns the device
                wav = self.batcher.submit_score(inp)
            else:
                # ThreadingHTTPServer handles requests concurrently, but
                # only one device program may run at a time — serialize
                with self.lock:
                    wav = synthesize_chunked(
                        self.infer, inp, max_words=self.max_words
                    )
            if wav.ndim != 1:
                # pipeline returned a mel (no vocoder loaded) — don't
                # serialize a spectrogram as PCM
                self._send(
                    400, b"error: no vocoder configured (set vocoder_ckpt)",
                    "text/plain",
                )
                return
            self._send(200, wav_bytes(wav, self.sample_rate), "audio/wav")
        except QueueFullError as e:
            # bounded admission: tell the client to back off, not that
            # the request was malformed
            self.send_response(503)
            body = f"error: {e}".encode()
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Retry-After", "1")
            self.end_headers()
            self.wfile.write(body)
        except Exception as e:  # surfacing the error to the UI
            if streaming_started:
                # headers are gone; truncate the chunked stream so the
                # client sees a hard error instead of silent silence
                self.close_connection = True
                return
            self._send(400, f"error: {e}".encode(), "text/plain")

    def _serial_stream(self, inp: Dict[str, Any]):
        """No-batcher streaming: synthesize chunk-by-chunk under the
        device lock, yielding each wav as it is produced."""
        for c in split_score_chunks(inp, max_words=self.max_words):
            with self.lock:
                yield self.infer.infer_once(c)


def synthesize_chunked(infer, inp: Dict[str, Any], max_words: int = 64) -> np.ndarray:
    """Synthesize one request, chunking long scores word-aligned
    (reference `gradio/infer.py:36-60`) and concatenating audio."""
    chunks = split_score_chunks(inp, max_words=max_words)
    if len(chunks) == 1:
        return infer.infer_once(inp)
    wavs = [infer.infer_once(c) for c in chunks]
    return np.concatenate(wavs)


def serve(
    infer,
    host: str = "127.0.0.1",
    port: int = 7860,
    max_batch: int = 8,
    batch_window_ms: float = 25.0,
    max_words: int = 64,
    max_queue: int = 128,
) -> ThreadingHTTPServer:
    """Start the demo server (non-blocking; returns the server object).

    max_batch > 1 routes requests through a `MicroBatcher` so concurrent
    scores share one device program; max_batch=0/1 restores the serial
    lock-per-request path. max_words is the word-aligned score-chunking
    granularity (reference `gradio/infer.py:36-60`). max_queue bounds
    pending score-chunks; beyond it requests get 503 + Retry-After."""
    SVSRequestHandler.infer = infer
    SVSRequestHandler.sample_rate = infer.hp["audio_sample_rate"]
    SVSRequestHandler.max_words = max_words
    SVSRequestHandler.batcher = (
        MicroBatcher(
            infer, max_batch=max_batch, window_ms=batch_window_ms,
            max_words=max_words, max_queue=max_queue,
        )
        if max_batch and max_batch > 1
        else None
    )
    httpd = ThreadingHTTPServer((host, port), SVSRequestHandler)
    # close the batcher worker when the server shuts down
    if SVSRequestHandler.batcher is not None:
        batcher = SVSRequestHandler.batcher
        orig_shutdown = httpd.shutdown

        def shutdown():
            orig_shutdown()
            batcher.close()

        httpd.shutdown = shutdown
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd


def launch_gradio(infer, **kwargs):  # pragma: no cover - optional dep
    """Gradio UI when the package is available (reference
    `gradio/infer.py` + `gradio_settings.yaml`)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed; use bisinger_tpu_torch.inference.server.serve"
        ) from e

    def run(text, notes, notes_duration, spk_name):
        wav = synthesize_chunked(
            infer,
            dict(text=text, notes=notes, notes_duration=notes_duration, spk_name=spk_name),
        )
        return infer.hp["audio_sample_rate"], wav

    demo = gr.Interface(
        fn=run,
        inputs=["text", "text", "text", "text"],
        outputs=gr.Audio(),
        title="BiSinger",
    )
    return demo.launch(**kwargs)


def main(argv: Optional[List[str]] = None):
    """Serve the flagship (or another run's files under --ckpt-dir) on the
    card, or on the CPU with --device cpu."""
    import argparse

    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch

    full_fp32()
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--ckpt-dir", default=FLAGSHIP_DIR,
                        help="hparams_diff.json, phone_set.json, spk_map.json and the weights")
    parser.add_argument("--hparams", default="", help="overrides, 'k=v,k2=[1,2]'")
    parser.add_argument("--device", default=None, help="default: the card; 'cpu' to ask for it")
    parser.add_argument(
        "--max-batch", type=int, default=8,
        help="micro-batching: max concurrent scores per device program "
        "(0/1 = serial)",
    )
    parser.add_argument(
        "--batch-window-ms", type=float, default=25.0,
        help="micro-batching: how long the first request waits for "
        "companions",
    )
    parser.add_argument(
        "--max-queue", type=int, default=128,
        help="admission bound: max pending score-chunks before requests "
        "get 503 + Retry-After (0 = unbounded)",
    )
    args = parser.parse_args(argv)
    infer = SVSInferTorch.from_checkpoint(args.ckpt_dir, device=args.device,
                                          hp_overrides=args.hparams or None)
    httpd = serve(
        infer, args.host, args.port,
        max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
        max_queue=args.max_queue,
    )
    print(f"| serving on http://{args.host}:{args.port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()


if __name__ == "__main__":
    main()
