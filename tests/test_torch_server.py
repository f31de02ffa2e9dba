"""The port's serving app and CLI (`bisinger_tpu_torch/inference/server.py`,
`bisinger_tpu_torch/run.py`) on the CPU: the cases of tests/test_server.py
on a fake pipeline, the micro-batcher's grouping, its queue bound's 503,
streaming, an HTTP round trip through a real tiny `SVSInferTorch`, and the
entry points' handling of the device."""

import json
import os
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from bisinger_tpu_torch.config import make_hparams
from bisinger_tpu_torch.inference import server
from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch
from bisinger_tpu_torch.inference.server import (
    MicroBatcher,
    serve,
    split_score_chunks,
    synthesize_chunked,
    wav_bytes,
)
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.utils.text_encoder import TokenTextEncoder

from torch_port_helpers import TINY


class FakeInfer:
    hp = {"audio_sample_rate": 24000}

    def infer_once(self, inp):
        return np.zeros(1000, np.float32)  # fixed length per chunk


class SlowBatchInfer:
    """Records each infer_batch group; the wav's length encodes the request
    id so routing can be checked."""

    hp = {"audio_sample_rate": 24000}

    def __init__(self, delay=0.05):
        self.calls, self.delay, self.lock = [], delay, threading.Lock()

    def infer_batch(self, inps):
        with self.lock:
            self.calls.append([i.get("rid", -1) for i in inps])
        time.sleep(self.delay)
        return [np.full(1000 + i.get("rid", 0), 0.25, np.float32) for i in inps]

    def infer_once(self, inp):
        return self.infer_batch([inp])[0]


def _long_score(n=10):
    return {"text": " ".join(["la"] * n), "notes": " | ".join(["C4"] * n),
            "notes_duration": " | ".join(["0.3"] * n)}


def _post(port, body, timeout=30):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _streamed_pcm(body: bytes) -> bytes:
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    assert struct.unpack("<I", body[24:28])[0] == 24000  # sample rate
    return body[44:]


def test_split_score_short_passthrough():
    inp = dict(text="a b", notes="C4 | D4", notes_duration="0.3 | 0.3")
    assert split_score_chunks(inp, max_words=4) == [inp]


def test_wav_bytes_header():
    b = wav_bytes(np.zeros(100, np.float32), 24000)
    assert b[:4] == b"RIFF" and b[8:12] == b"WAVE"
    assert len(b) == 44 + 200


def test_synthesize_chunked_concats():
    """Long scores split word-aligned: text, notes and durations chunk together."""
    inp = _long_score(10)
    chunks = split_score_chunks(inp, max_words=4)
    assert len(chunks) == 3
    for c in chunks:
        assert len(c["text"].split()) == len(c["notes"].split("|"))
        assert len(c["notes"].split("|")) == len(c["notes_duration"].split("|"))
    assert len(synthesize_chunked(FakeInfer(), inp, max_words=4)) == 3 * 1000


def test_no_vocoder_rejected_over_http():
    """A pipeline answering a mel gets a 400, never a spectrogram as PCM."""

    class MelOnly:
        hp = {"audio_sample_rate": 24000}

        def infer_once(self, inp):
            return np.zeros((50, 80), np.float32)

    httpd = serve(MelOnly(), host="127.0.0.1", port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(httpd.server_address[1], {"text": "la"})
        assert e.value.code == 400 and b"vocoder" in e.value.read()
    finally:
        httpd.shutdown()


def test_http_roundtrip():
    httpd = serve(FakeInfer(), host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health") as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/") as r:
            assert b"BiSinger" in r.read()
        with _post(port, {"text": "la la la"}) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            assert r.read()[:4] == b"RIFF"
    finally:
        httpd.shutdown()


def test_http_error_surfaced():
    class Boom:
        hp = {"audio_sample_rate": 24000}

        def infer_once(self, inp):
            raise ValueError("word/note mismatch 3 vs 4")

    httpd = serve(Boom(), host="127.0.0.1", port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(httpd.server_address[1], {"text": "x"})
        assert e.value.code == 400 and b"mismatch" in e.value.read()
    finally:
        httpd.shutdown()


def test_concurrent_requests_share_groups():
    infer = SlowBatchInfer()
    mb = MicroBatcher(infer, max_batch=8, window_ms=80.0)
    try:
        results = {}
        threads = [threading.Thread(target=lambda r=r: results.__setitem__(
            r, mb.submit_score({"text": "la", "rid": r}))) for r in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert all(len(results[r]) == 1000 + r for r in range(6))
        assert max(mb.batch_sizes) > 1 and sum(mb.batch_sizes) == 6
        assert mb.batch_sizes == [len(c) for c in infer.calls]
    finally:
        mb.close()


def test_queue_bound_maps_to_http_503():
    httpd = serve(SlowBatchInfer(delay=0.4), port=0, max_batch=2, batch_window_ms=0.0,
                  max_queue=1)
    port = httpd.server_address[1]
    codes, lock = [], threading.Lock()

    def post(rid):
        try:
            with _post(port, {"rid": rid}) as r:
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
            if code == 503:
                assert e.headers.get("Retry-After") == "1"
        with lock:
            codes.append(code)

    try:
        threads = [threading.Thread(target=post, args=(r,)) for r in range(6)]
        for th in threads:
            th.start()
            time.sleep(0.02)
        for th in threads:
            th.join()
        assert 503 in codes and 200 in codes and len(codes) == 6, codes
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("max_batch", [8, 1])
def test_http_streaming_equals_whole_response(max_batch):
    """{"stream": true} answers chunked audio/wav whose PCM equals the whole
    response's, with and without the micro-batcher."""
    httpd = serve(SlowBatchInfer(delay=0.02), port=0, max_batch=max_batch,
                  batch_window_ms=10.0, max_words=4)
    port = httpd.server_address[1]
    try:
        with _post(port, {**_long_score(10), "stream": True}) as r:
            assert r.headers.get("Transfer-Encoding") == "chunked"
            streamed = r.read()
        with _post(port, _long_score(10)) as r:
            whole = r.read()
        assert _streamed_pcm(streamed) == whole[44:] and len(whole) == 44 + 2 * 3 * 1000
    finally:
        httpd.shutdown()


PHONES = ["AY", "AE", "N", "T", "S", "B", "IY", "UW", "AH", "F", "L", "JH", "AA", "NG", "Y",
          "<AP>", "<SP>"]


def _tiny_svs():
    """A real pipeline at the tiny widths, seeded random weights, K=8."""
    torch.manual_seed(0)
    hp = make_hparams(dict(TINY, K_step=8, timesteps=8, pndm_speedup=2, bucket_tokens=[8, 16],
                           bucket_frames=[32, 64]))
    enc = TokenTextEncoder(PHONES, replace_oov=",")
    return SVSInferTorch(hp, GaussianDiffusion(hp, enc.vocab_size), PitchExtractor(hp),
                         HifiGanGenerator(hp), device="cpu", encoder=enc,
                         spk_map={"Alto-1": 0, "Tenor-1": 1})


def test_tiny_pipeline_over_http():
    """Scores in, 24 kHz WAVs out, through the micro-batcher and a real
    pipeline on the CPU: three concurrent requests, one of them streamed."""
    svs = _tiny_svs()
    httpd = serve(svs, port=0, max_batch=4, batch_window_ms=200.0, max_words=2)
    port = httpd.server_address[1]
    scores = [dict(text="ai", notes="C4", notes_duration="0.1", spk_name="Tenor-1"),
              dict(text="SP love", notes="rest | C4 D4", notes_duration="0.05 | 0.1 0.1"),
              dict(text="la ai la", notes="C4 | D4 | E4", notes_duration="0.1 | 0.1 | 0.1",
                   stream=True)]
    bodies = {}

    def post(i):
        with _post(port, scores[i], timeout=120) as r:
            bodies[i] = r.read()

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert sorted(bodies) == [0, 1, 2]
        for body in bodies.values():
            pcm = np.frombuffer(_streamed_pcm(body), "<i2")
            assert len(pcm) > 0 and len(pcm) % 128 == 0 and np.abs(pcm).max() > 0
        assert max(server.SVSRequestHandler.batcher.batch_sizes) > 1
    finally:
        httpd.shutdown()


def test_cli_writes_wavs_on_the_cpu(tmp_path, capsys):
    from bisinger_tpu_torch import run
    from scipy.io import wavfile

    scores = [dict(item_name="pinyin", text="SP wo ai ni", notes="rest | C4 | D4 | E4",
                   notes_duration="0.05 | 0.1 | 0.1 | 0.1", spk_name="Alto-1"),
              dict(item_name="english", text="hello", notes="C4 D4",
                   notes_duration="0.1 0.1")]
    fn = tmp_path / "scores.json"
    fn.write_text(json.dumps(scores))
    rc = run.main(["--infer", "--input", str(fn), "--out", str(tmp_path / "out"),
                   "--device", "cpu", "--hparams",
                   "K_step=2,pndm_speedup=1,bucket_tokens=[16],bucket_frames=[64]"])
    assert rc == 0
    paths = [ln for ln in capsys.readouterr().out.splitlines() if not ln.startswith("| ")]
    assert paths == [str(tmp_path / "out" / f"{n}.wav") for n in ("pinyin", "english")]
    for p in paths:
        sr, wav = wavfile.read(p)
        assert sr == 24000 and wav.dtype == np.int16 and len(wav) % 128 == 0
        assert 0 < np.abs(wav).max()


def test_cli_without_input_exits_2(capsys):
    from bisinger_tpu_torch import run

    assert run.main(["--infer", "--device", "cpu"]) == 2
    assert "--infer requires --input" in capsys.readouterr().err
    with pytest.raises(ValueError, match="binary_data_dir is not set"):
        run.main([])


def test_entry_points_need_the_card_unless_the_cpu_is_named(monkeypatch, tmp_path):
    from bisinger_tpu_torch import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SVSInferTorch.from_checkpoint()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--infer", "--input", str(tmp_path / "scores.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--port", "0"])
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        SVSInferTorch.from_checkpoint(device="cuda")


def test_from_checkpoint_names_a_missing_vocabulary(tmp_path):
    for fn in ("hparams_diff.json", "spk_map.json"):
        os.symlink(os.path.join(FLAGSHIP_DIR, fn), tmp_path / fn)
    with pytest.raises(FileNotFoundError, match="phone_set.json"):
        SVSInferTorch.from_checkpoint(str(tmp_path), device="cpu")
