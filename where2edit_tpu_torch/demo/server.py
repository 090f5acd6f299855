"""The web demo over the standard library's HTTP server (counterpart of
where2edit_tpu/demo/server.py): seeded faces, gallery faces and e4e
inversions, edited with a prompt, a region, strength and coverage.

    python -m where2edit_tpu_torch.demo.server --port 7860 \\
        --mapper final_mapper.pt --clip_ckpt ViT-B-32.pt [--device cpu]

Routes: GET ``/`` (the page), GET ``/celebs`` (the gallery's names), POST
``/edit`` with JSON ``{seed | celeb | source: "session", prompt, region,
strength, coverage}`` → base64 JPEGs of the original, the edit and the
attention map and the milliseconds, POST ``/invert`` with ``{image:
<base64 PNG/JPEG>}`` → the face inverted by e4e into the session. A bad
request answers 400 with ``{"error": ...}``. Pillow is imported only to
encode and decode images; ``edit_request`` does the work of ``/edit`` on
tensors without it.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from where2edit_tpu_torch.demo.app import (
    REGION_PROMPTS,
    build_argparser,
    load_gallery,
    load_psp,
    load_session,
)
from where2edit_tpu_torch.models.clip_tokenizer import tokenize
from where2edit_tpu_torch.utils.images import to_uint8

PAGE = """<!DOCTYPE html>
<html><head><title>where2edit demo</title><style>
body{font-family:sans-serif;max-width:1100px;margin:2em auto}
img{width:320px;image-rendering:auto;border:1px solid #ccc}
.row{display:flex;gap:12px}label{display:block;margin:6px 0}
</style></head><body>
<h2>Where You Edit is What You Get</h2>
<label>Source <select id=source><option value=syn selected>Synthesized (seed)
</option></select></label>
<label>Seed <input id=seed type=number value=0></label>
<label>Prompt <input id=prompt size=50 value="a person with grey hair"></label>
<label>Region <select id=region>
<option>skin</option><option>nose</option><option>eyes</option>
<option>eyebrows</option><option>ears</option><option>mouth</option>
<option selected>hair</option></select></label>
<label>Strength α <input id=strength type=range min=0 max=0.3 step=0.01 value=0.1>
<span id=sv>0.1</span></label>
<label>Coverage <input id=coverage type=range min=0 max=1 step=0.05 value=0>
<span id=cv>0</span></label>
<button onclick="edit()">Edit</button> <span id=status></span>
<div class=row>
<div><h4>original</h4><img id=orig></div>
<div><h4>edited</h4><img id=edit></div>
<div><h4>attention</h4><img id=att></div>
</div>
<script>
strength.oninput=()=>sv.textContent=strength.value;
coverage.oninput=()=>cv.textContent=coverage.value;
fetch('/celebs').then(r=>r.json()).then(j=>{
 for(const n of j.celebs){const o=document.createElement('option');
  o.value='celeb:'+n;o.textContent=n;source.appendChild(o);}});
async function edit(){
 status.textContent='running…';
 const src=source.value, body={seed:+seed.value,prompt:prompt.value,
  region:region.value,strength:+strength.value,coverage:+coverage.value};
 if(src.startsWith('celeb:')) body.celeb=src.slice(6);
 const r = await fetch('/edit',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify(body)});
 const j = await r.json();
 orig.src='data:image/jpeg;base64,'+j.original;
 edit.src='data:image/jpeg;base64,'+j.edited;
 att.src='data:image/jpeg;base64,'+j.attention;
 status.textContent=j.ms.toFixed(0)+' ms';
}
</script></body></html>"""


class BadRequest(ValueError):
    """A request the server answers with 400 and this message."""


def _jpeg_b64(img, value_range=(-1, 1)) -> str:
    """The first image of an NHWC batch as a base64 JPEG (quality 92)."""
    from PIL import Image  # noqa: PLC0415

    u8 = to_uint8(img, value_range)[0]
    if u8.shape[-1] == 1:
        u8 = np.repeat(u8, 3, axis=-1)
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, format="JPEG", quality=92)
    return base64.b64encode(buf.getvalue()).decode()


def edit_request(session, req: dict, gallery=None) -> tuple:
    """The work of POST ``/edit``: load the face the request names (a
    gallery ``celeb``, the ``session``'s current face, else ``seed``) and
    edit it with ``prompt`` in ``region`` at ``strength`` and ``coverage``.
    Returns (original, edited, attention map) as CPU tensors and the
    milliseconds from the request to those copies; raises ``BadRequest``."""
    t0 = time.perf_counter()
    if req.get("celeb") and gallery is not None:
        try:
            gallery.load(str(req["celeb"]))
        except (KeyError, RuntimeError) as e:
            # an unknown name, or an images_dir entry with no e4e encoder
            raise BadRequest(str(e)) from e
    elif req.get("source") == "session":
        if session.latent is None:
            raise BadRequest("no face loaded; POST /invert or pass seed/celeb")
    else:
        session.load_synthetic(int(req.get("seed", 0)))
    toks = tokenize([req.get("prompt", "")])
    att = tokenize([REGION_PROMPTS.get(req.get("region", "hair"), "grey hair")])
    threshold = 1.0 - 0.25 * float(req.get("coverage", 0.0))
    img, amap = session.edit(toks, att,
                             strength_alpha=float(req.get("strength", 0.1)),
                             attention_threshold=threshold)
    # the copies wait for the device
    out = session.image.cpu(), img.cpu(), amap.cpu()
    return (*out, (time.perf_counter() - t0) * 1e3)


def make_handler(session, lock, gallery=None, psp=None):
    """The request handler class of a server over ``session``; ``lock``
    serialises the requests' use of it."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") == "/celebs":
                self._json({"celebs": gallery.names() if gallery is not None else []})
                return
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            if self.path.rstrip("/") == "/invert":
                self._invert(req)
                return
            with lock:
                try:
                    original, edited, amap, ms = edit_request(session, req, gallery)
                except BadRequest as e:
                    self._json({"error": str(e)}, 400)
                    return
            self._json({"original": _jpeg_b64(original), "edited": _jpeg_b64(edited),
                        "attention": _jpeg_b64(amap, (0, 1)), "ms": ms})

        def _invert(self, req):
            """``{"image": <base64 PNG/JPEG>}`` → the face encoded to W+
            by e4e and loaded into the session; follow with ``/edit``
            ``{"source": "session"}``."""
            if psp is None:
                self._json({"error": "no e4e encoder loaded "
                            "(start with --e4e_ckpt)"}, 400)
                return
            from PIL import Image  # noqa: PLC0415

            try:
                raw = base64.b64decode(req.get("image", ""))
                pil = Image.open(io.BytesIO(raw)).convert("RGB")
            except Exception:
                self._json({"error": "invalid image payload"}, 400)
                return
            x = np.asarray(pil.resize((256, 256)), np.float32) / 127.5 - 1.0
            with lock:
                w = psp.encode(torch.from_numpy(x[None]).to(psp.device))
                session.load_latent(w)
                body = {"original": _jpeg_b64(session.image),
                        "latent_shape": list(w.shape)}
            self._json(body)

    return Handler


def main(argv=None):
    p = build_argparser()
    p.add_argument("--port", type=int, default=7860)
    args = p.parse_args(argv)
    session = load_session(args)
    psp = load_psp(args)
    gallery = load_gallery(args, session, psp)
    # the first edit builds cuDNN plans and K1's prepared weights
    session.load_synthetic(0)
    session.edit(tokenize(["warmup"]))
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(session, threading.Lock(), gallery, psp))
    print(f"demo ready → http://localhost:{server.server_address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
