"""The port's HTTP front end over its online continuous engine, on the CPU
at tiny widths (f32), on an ephemeral port: tokens equal the single-page
pipeline's (held to the JAX package in tests/test_torch_e2e.py), concurrent
requests, health and stats, the 400 and 404 paths, SSE streaming."""

import concurrent.futures
import dataclasses
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
from deepseek_ocr2_tpu_torch.runtime.http_server import OCRHttpServer
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

import reference_torch_vision as refv


def _tiny_tokenizer():
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tok


@pytest.fixture(scope="module")
def served():
    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    params, report = tocr2.params_from_flat(refv.random_ocr2_flat(cfg, seed=21), cfg)
    report.raise_on_errors()
    pipe = OCR2Pipeline(params, cfg, _tiny_tokenizer(), device="cpu", kv_dtype="float32", act_dtype="float32")
    engine = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=4)
    engine.start(ngram_size=3)
    server = OCRHttpServer(engine, port=0, include_token_ids=True).start_background()
    yield pipe, server
    server.shutdown()
    engine.stop(timeout=60)


def _png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _img(seed, h=120, w=160):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8))


def _request(port, path, body):
    return urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                  headers={"Content-Type": "image/png"}, method="POST")


def _post(port, path, body, timeout=120):
    with urllib.request.urlopen(_request(port, path, body), timeout=timeout) as r:
        return json.loads(r.read())


def _post_sse(port, path, body, timeout=120):
    events = []
    with urllib.request.urlopen(_request(port, path, body), timeout=timeout) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        for line in r:
            line = line.strip()
            if line.startswith(b"data: "):
                events.append(json.loads(line[len(b"data: "):]))
    return events


def test_http_ocr_token_exact(served):
    pipe, server = served
    img = _img(3, 300, 500)  # a crop page
    want = pipe.generate_ocr(img, max_new_tokens=6, ngram_size=3)
    out = _post(server.port, "/v1/ocr?max_new_tokens=6", _png(img))
    assert out["token_ids"] == want.token_ids
    assert out["text"] == want.text and out["new_tokens"] == want.new_tokens


def test_http_concurrent_requests_batch(served):
    pipe, server = served
    imgs = [_img(5 + i) for i in range(4)]
    wants = [pipe.generate_ocr(i, max_new_tokens=5, ngram_size=3) for i in imgs]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(lambda im: _post(server.port, "/v1/ocr?max_new_tokens=5", _png(im)), imgs))
    for want, out in zip(wants, outs):
        assert out["token_ids"] == want.token_ids


def test_http_health_and_stats(served):
    _, server = served
    _post(server.port, "/v1/ocr?max_new_tokens=2", _png(_img(1)))
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/v1/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["slots"] == 2 and stats["requests"] >= 1 and stats["page_size"] == 128


def test_http_bad_image_400(served):
    _, server = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/v1/ocr", b"this is not an image")
    assert e.value.code == 400


def test_http_unknown_path_404(served):
    _, server = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/v1/nope", b"x")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{server.port}/nope", timeout=30)
    assert e.value.code == 404


def test_http_over_budget_request_400_engine_survives(served):
    pipe, server = served
    img = _img(7)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/v1/ocr?max_new_tokens=100000", _png(img))
    assert e.value.code == 400
    want = pipe.generate_ocr(img, max_new_tokens=4, ngram_size=3)
    assert _post(server.port, "/v1/ocr?max_new_tokens=4", _png(img))["token_ids"] == want.token_ids


def test_http_streaming_sse(served):
    """stream=1: the SSE events reassemble exactly the non-streamed result."""
    pipe, server = served
    img = _img(11)
    want = pipe.generate_ocr(img, max_new_tokens=6, ngram_size=3)
    events = _post_sse(server.port, "/v1/ocr?max_new_tokens=6&stream=1", _png(img))
    assert len(events) >= 2, events
    final = events[-1]
    assert final.get("done") is True
    assert final["text"] == want.text and final["new_tokens"] == want.new_tokens
    assert [t for ev in events[:-1] for t in ev["token_ids"]] == want.token_ids[want.prompt_len:]
    assert "".join(ev["text_delta"] for ev in events[:-1]).strip() == want.text


def test_http_streaming_bad_args_400(served):
    _, server = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_sse(server.port, "/v1/ocr?max_new_tokens=100000&stream=1", _png(_img(12)))
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_sse(server.port, "/v1/ocr?max_new_tokens=abc&stream=1", _png(_img(12)))
    assert e.value.code == 400
