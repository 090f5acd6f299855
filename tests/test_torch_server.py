"""The port's web demo (``demo/server.py``) over real HTTP on the CPU at
stylegan_size 32 (attention and cluster layer 7): GET ``/`` and
``/celebs``; POST ``/edit`` from a seed, a gallery face and the session's
face, with its JPEGs decoded by Pillow; POST ``/invert`` through a random
reference-layout e4e; and the JAX server's 400s (``/invert`` without an
encoder or with a bad payload, an unknown gallery face, ``source=session``
before any face). ``edit_request`` gives the handler's numbers without
HTTP."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from where2edit_tpu_torch.demo import server
from where2edit_tpu_torch.demo.app import build_session
from where2edit_tpu_torch.demo.gallery import CelebGallery
from where2edit_tpu_torch.models.encoders import Encoder4Editing
from where2edit_tpu_torch.models.psp import PSp
from where2edit_tpu_torch.models.stylegan2 import Generator

SIZE, LAYER, N_LATENT = 32, 7, 8


@pytest.fixture(scope="module")
def psp():
    rng = torch.Generator().manual_seed(0)
    enc = Encoder4Editing(stylegan_size=SIZE, rng=rng)
    dec = Generator(SIZE, rng=rng)
    state = {**{f"encoder.{k}": v for k, v in enc.state_dict().items()},
             **{f"decoder.{k}": v for k, v in dec.state_dict().items()}}
    return PSp.from_state_dict({"state_dict": state,
                                "latent_avg": torch.randn(N_LATENT, 512)},
                               stylegan_size=SIZE, device="cpu")


def _serve(session, gallery=None, psp=None):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(
        session, threading.Lock(), gallery, psp))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _jpeg(b64):
    from PIL import Image  # noqa: PLC0415

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


@pytest.fixture(scope="module")
def served(psp):
    torch.set_num_threads(2)
    session = build_session(SIZE, LAYER, LAYER, device="cpu")
    httpd, url = _serve(session, CelebGallery(session), psp)
    yield session, url
    httpd.shutdown()
    httpd.server_close()


def test_torch_server_routes_and_errors(served):
    session, url = served
    code, ctype, page = _get(url + "/")
    assert code == 200 and ctype == "text/html" and b"/edit" in page
    code, _, body = _get(url + "/celebs")
    assert code == 200 and json.loads(body)["celebs"][:2] == ["Celeb 1", "Celeb 2"]
    # source=session before any face is loaded
    assert session.latent is None
    code, body = _post(url + "/edit", {"source": "session", "prompt": "grey hair"})
    assert code == 400 and "no face loaded" in body["error"]
    code, body = _post(url + "/edit", {"celeb": "Nobody", "prompt": "grey hair"})
    assert code == 400 and "Nobody" in body["error"]
    code, body = _post(url + "/invert", {"image": "not base64 of an image"})
    assert code == 400 and body["error"] == "invalid image payload"


def test_torch_server_edits(served):
    session, url = served
    code, body = _post(url + "/edit", {"seed": 3, "prompt": "a person with grey hair",
                                       "region": "hair", "strength": 0.2,
                                       "coverage": 0.4})
    assert code == 200 and body["ms"] > 0
    for key in ("original", "edited", "attention"):
        img = _jpeg(body[key])
        assert img.shape[2] == 3 and img.dtype == np.uint8
    assert _jpeg(body["edited"]).shape == (SIZE, SIZE, 3)
    seeded = _jpeg(body["original"])
    code, body = _post(url + "/edit", {"celeb": "Celeb 2", "prompt": "pale skin"})
    assert code == 200
    celeb = _jpeg(body["original"])
    assert not np.array_equal(celeb, seeded)
    code, body = _post(url + "/edit", {"source": "session", "prompt": "red lips"})
    assert code == 200 and np.array_equal(_jpeg(body["original"]), celeb)


def test_torch_server_invert(served):
    from PIL import Image  # noqa: PLC0415

    _, url = served
    pixels = np.random.default_rng(1).integers(0, 256, (40, 48, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="PNG")
    code, body = _post(url + "/invert",
                       {"image": base64.b64encode(buf.getvalue()).decode()})
    assert code == 200 and body["latent_shape"] == [1, N_LATENT, 512]
    code, edit = _post(url + "/edit", {"source": "session", "prompt": "grey hair"})
    assert code == 200
    assert np.array_equal(_jpeg(edit["original"]), _jpeg(body["original"]))


def test_torch_server_without_encoder_and_edit_request():
    session = build_session(SIZE, LAYER, LAYER, device="cpu")
    httpd, url = _serve(session)
    try:
        code, body = _post(url + "/invert", {"image": ""})
        assert code == 400 and "--e4e_ckpt" in body["error"]
        code, _, body = _get(url + "/celebs")
        assert json.loads(body) == {"celebs": []}
    finally:
        httpd.shutdown()
        httpd.server_close()
    original, edited, amap, ms = server.edit_request(
        session, {"seed": 5, "prompt": "grey hair", "coverage": 1.0})
    assert original.shape == edited.shape == (1, SIZE, SIZE, 3)
    assert amap.shape[-1] == 1 and float(amap.max()) <= 1.0 and ms > 0
    assert original.device.type == "cpu"
    with pytest.raises(server.BadRequest):
        server.edit_request(session, {"celeb": "x"}, CelebGallery(session))
