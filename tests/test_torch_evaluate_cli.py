"""The port's evaluation path on the CPU at generator size 32, attention
and cluster layer 4 (the JAX package's own evaluate tests' size):

* ``cli/evaluate.py`` in both modes through ``main``, from checkpoint
  files (generator, mapper, a small CLIP, the seeded ArcFace of
  ``torch_parity``, a tiny e4e made from the port's own seeded
  ``Encoder4Editing``) and synthetic CelebAMask-HQ pairs;
* the port's ``EditEvaluator`` against the JAX package's on the same
  weights, the same W+ (injected through ``edit_fn``: seeded faces differ
  by construction) and the same token ids (the tokenizers differ by
  design), with the CLI's default FID features (CLIP image features; the
  InceptionV3 extractor is held in tests/test_torch_inception.py): the
  CLIP improvement equal, the ID cosine within 1e-4 absolute, the feature
  pools within 1e-3 of their largest magnitude (two syntheses, the image
  at 2e-3 as tests/test_torch_edit.py, then CLIP); the FID is held as a
  statistic on the port's own float64 pools (1e-9), never across
  packages: with 4 samples of 512-d features the covariance has rank 3,
  and fp32 noise near its zero eigenvalues becomes square-root-sized
  differences;
* ``calculate_iou``'s raw maps against the JAX CLI's (full taps,
  subsampled inside the mapper) at 1e-4 absolute, and the per-class IoU
  equal for each class whose maps hold no value within 1e-4 of the 0.8
  step of ``binarize_for_iou`` (a value there may binarise either way);
* ``CelebAMaskHQ`` reading its pairs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.convert.clip import convert_clip_params
from where2edit_tpu.convert.irse import convert_backbone_params
from where2edit_tpu.demo.api import EditSession as JEditSession
from where2edit_tpu.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLinStyle as JMapper,
)
from where2edit_tpu.editing.attention_mappers import tap_controls
from where2edit_tpu.eval import iou as jiou
from where2edit_tpu.eval import metrics as jmetrics
from where2edit_tpu.losses.clip_loss import CLIPLoss as JCLIPLoss
from where2edit_tpu.losses.id_loss import IDLoss as JIDLoss
from where2edit_tpu.models.clip_model import CLIP as JCLIP
from where2edit_tpu.models.irse import Backbone as JBackbone
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.cli import evaluate
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLinStyle as TMapper,
)
from where2edit_tpu_torch.eval import iou as tiou
from where2edit_tpu_torch.eval.metrics import EditEvaluator
from where2edit_tpu_torch.models.clip_model import CLIP
from where2edit_tpu_torch.models.clip_tokenizer import tokenize
from where2edit_tpu_torch.models.encoders import Encoder4Editing
from where2edit_tpu_torch.train.corpus import IOU_PROMPTS
from where2edit_tpu_torch.train.datasets import CelebAMaskHQ

from torch_parity import (
    TINY_CLIP,
    arcface_state,
    jax_generator,
    np_tree,
    perturb,
    position_centres,
    t,
    torch_generator,
)

SIZE, LAYER, BATCH, ITERS = 32, 4, 2, 2
POOL_TOL, ID_TOL, MAP_TOL, STATS_TOL = 1e-3, 1e-4, 1e-4, 1e-9
PROMPTS = ["grey hair", "a smiling face", "thick eyebrows", "narrow eyes"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX generator and mapper (perturbed where a fresh init is dormant,
    k-means centres on position only, the map's bias at 1 so it straddles
    0.8), a small CLIP and the seeded ArcFace: JAX variables, and the same
    weights as the port's checkpoint files."""
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    tmp = tmp_path_factory.mktemp("evaluate")
    rng = np.random.default_rng(5)
    jgen, gvars = jax_generator(SIZE, seed=5)
    jg = jax.tree.map(jnp.asarray, gvars)
    blend, keep = tap_controls(SIZE, LAYER, LAYER)
    cap = jax.jit(lambda v, w: jgen.apply(
        v, [w], input_is_latent=True, randomize_noise=False,
        return_features=True, tap_subsample=blend, tap_indices=keep))(
        jg, jnp.zeros((1, jgen.n_latent, 512)))
    feats = list(cap.feature_map) + [jg["params"]["input"]["input"]]
    jm = JMapper(layers=jgen.n_latent, attention_layer=LAYER,
                 cluster_layer=LAYER, generator_size=SIZE)
    mv = jax.jit(lambda *a: jm.init({"params": jax.random.PRNGKey(1)}, *a, blend,
                                    deterministic_noise=True))(
        jnp.zeros((1, 512)), cap.style_vector, feats)
    mv = {k: dict(x) for k, x in np_tree(mv).items()}
    mv["params"] = perturb(mv["params"], rng)
    mv["params"]["initial_bias"] = np.ones((1,), np.float32)
    mv["clusters"] = {"initial_state": position_centres(rng)}

    tgen = torch_generator(gvars, SIZE)
    tmap = TMapper(layers=tgen.n_latent, attention_layer=LAYER,
                   cluster_layer=LAYER, generator_size=SIZE)
    convert.load_converted(tmap, convert.mapper_state_dict(mv))
    clip = CLIP(**TINY_CLIP, rng=torch.Generator().manual_seed(2))
    arc = arcface_state(seed=3)
    files = {name: str(tmp / f"{name}.pt") for name in
             ("gen", "mapper", "clip", "arcface")}
    for name, sd in (("gen", {"g_ema": tgen.state_dict()}),
                     ("mapper", tmap.state_dict()), ("clip", clip.state_dict()),
                     ("arcface", arc)):
        torch.save(sd, files[name])
    jclip = JCLIP(**TINY_CLIP)
    jclip_vars = jax.tree.map(jnp.asarray, convert_clip_params(
        clip.state_dict(), vision_layers=TINY_CLIP["vision_layers"],
        text_layers=TINY_CLIP["text_layers"]))
    return dict(jgen=jgen, jg=jg, jm=jm, mv=jax.tree.map(jnp.asarray, mv),
                jclip=jclip, jclip_vars=jclip_vars, arc=arc,
                files=files, n_latent=tgen.n_latent, tmp=tmp)


def _cli_args(world, *extra) -> list:
    f = world["files"]
    return ["--device", "cpu", "--stylegan_size", str(SIZE), "--attention_layer",
            str(LAYER), "--cluster_layer", str(LAYER), "--ckpt", f["gen"],
            "--mapper", f["mapper"], "--clip_ckpt", f["clip"], *extra]


def _port_session(world):
    args = evaluate.build_argparser().parse_args(["edits", *_cli_args(world)])
    return evaluate.load_models(args)


def test_torch_evaluate_edits_cli(world, capsys):
    f = world["files"]
    result = evaluate.main(["edits", *_cli_args(world), "--iterations", str(ITERS),
                            "--batch", str(BATCH), "--ir_se50_weights", f["arcface"],
                            "--description_dir", str(world["tmp"] / "missing")])
    assert set(result) == {"clip_improvement", "fid_features", "n", "id_cosine"}
    assert result["n"] == ITERS * BATCH
    assert 0.0 <= result["clip_improvement"] <= 1.0
    assert np.isfinite(result["fid_features"]) and result["fid_features"] >= 0.0
    assert -1.0 <= result["id_cosine"] <= 1.0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == pytest.approx(result)


def test_torch_edit_evaluator_matches_jax(world):
    rng = np.random.default_rng(11)
    bank = rng.standard_normal((ITERS, BATCH, world["n_latent"], 512)).astype(np.float32)
    tokens = [tokenize(PROMPTS[2 * i: 2 * i + BATCH]) for i in range(ITERS)]

    # the port, loaded by the CLI's own functions
    session, closs = _port_session(world)
    f = world["files"]
    t_eval = EditEvaluator(
        edit_fn=evaluate.make_edit_fn(session, wplus_for=lambda i: t(bank[i])),
        encode_image=closs.encode_image, encode_text=closs.encode_text,
        id_extract=evaluate.load_id_extract(f["arcface"], "cpu"))
    got = t_eval.run(range(ITERS), [torch.from_numpy(x).long() for x in tokens])

    # JAX, as where2edit_tpu/cli/evaluate.py composes it
    jcl = JCLIPLoss(world["jclip"], world["jclip_vars"], SIZE)
    js = JEditSession(generator=world["jgen"], gen_vars=world["jg"], mapper=world["jm"],
                      mapper_vars=world["mv"], clip_encode_text=jcl.encode_text,
                      attention_layer=LAYER)

    def j_edit_fn(i, text_feats):
        js.load_latent(jnp.asarray(bank[i]))
        img, _, _ = js._edit(text_features=text_feats, attention_text_features=text_feats,
                             latent=js.latent, feature_map=js.feature_map,
                             mapper_feature_map=js.mapper_feature_map,
                             strength_alpha=jnp.float32(0.1),
                             attention_threshold=jnp.float32(0.75))
        return js.image, img

    jnet = JBackbone(input_size=112, drop_ratio=0.6)
    bvars = jax.tree.map(jnp.asarray, convert_backbone_params(world["arc"]))
    id_fn = jax.jit(JIDLoss(jnet, bvars).apply_extract_feats)
    j_pools = []

    def j_fid(img):  # the default FID features, recorded
        j_pools.append(np.asarray(jcl.encode_image(img)))
        return j_pools[-1]

    want = jmetrics.EditEvaluator(
        edit_fn=j_edit_fn, encode_image=jcl.encode_image, encode_text=jcl.encode_text,
        id_extract=lambda x: id_fn(bvars, x), fid_extract=j_fid,
    ).run(range(ITERS), [jnp.asarray(x) for x in tokens])

    assert got["n"] == want["n"] == ITERS * BATCH
    assert got["clip_improvement"] == want["clip_improvement"]
    assert abs(got["id_cosine"] - want["id_cosine"]) <= ID_TOL
    j_gen = np.concatenate(j_pools[0::2])
    j_orig = np.concatenate(j_pools[1::2])
    for mine, theirs in ((t_eval.feats_gen, j_gen), (t_eval.feats_orig, j_orig)):
        assert mine.shape == theirs.shape == (ITERS * BATCH, 512)
        err = np.abs(mine - theirs).max() / np.abs(theirs).max()
        assert err <= POOL_TOL, err
    np.testing.assert_allclose(
        got["fid_features"], jmetrics.frechet_distance(t_eval.feats_gen, t_eval.feats_orig),
        rtol=STATS_TOL)


def _labels(rng, n: int, size: int):
    """Blocky 0-13 label maps (4×4 cells), so every region has area."""
    cells = rng.integers(0, 14, (n, size // 4, size // 4))
    return cells.repeat(4, 1).repeat(4, 2)


def test_torch_iou_maps_match_jax(world):
    rng = np.random.default_rng(12)
    bank = rng.standard_normal((2, 1, world["n_latent"], 512)).astype(np.float32)
    labels = _labels(rng, 2, 8)  # the map's size at layer 4 of a 32² generator

    session, closs = _port_session(world)
    calls = evaluate.iou_callables(session)
    raw_t = []

    def t_mapper(*a):
        mo = calls["mapper_apply"](*a)
        raw_t.append(mo.attention_map.numpy())
        return mo

    t_class, t_macro = tiou.calculate_iou(
        invert_fn=lambda i: t(bank[i]), features_fn=calls["features_fn"],
        mapper_apply=t_mapper, encode_text=closs.encode_text,
        tokenizer=calls["tokenizer"], attention_layer=LAYER,
        image_label_pairs=[(i, labels[i]) for i in range(2)])

    # JAX, as where2edit_tpu/cli/evaluate.py's iou mode: full taps, the
    # mapper subsamples inside
    jgen, jg, jm, mv = world["jgen"], world["jg"], world["jm"], world["mv"]
    jcl = JCLIPLoss(world["jclip"], world["jclip_vars"], SIZE)
    synth = jax.jit(lambda v, w: jgen.apply(v, [w], input_is_latent=True,
                                            randomize_noise=False, return_features=True))
    mapper = jax.jit(lambda v, tf, s, f, bs: jm.apply(
        v, tf, s, f, bs, train=False, finalize=False, deterministic_noise=True),
        static_argnums=4)
    last, raw_j = {}, []

    def j_features(w):
        out = synth(jg, w)
        const = jg["params"]["input"]["input"]
        last["styles"] = out.style_vector
        return list(out.feature_map) + [jnp.broadcast_to(const, (w.shape[0], *const.shape[1:]))]

    def j_mapper(tf, latent, feats, bs):
        mo = mapper(mv, tf, last["styles"], feats, bs)
        raw_j.append(np.asarray(mo.attention_map))
        return mo

    j_class, j_macro = jiou.calculate_iou(
        invert_fn=lambda i: jnp.asarray(bank[i]), features_fn=j_features,
        mapper_apply=j_mapper, encode_text=jcl.encode_text,
        tokenizer=lambda texts: tokenize(texts), attention_layer=LAYER,
        image_label_pairs=[(i, labels[i]) for i in range(2)])

    assert len(raw_t) == len(raw_j) == 2 * len(IOU_PROMPTS)
    for a, b in zip(raw_t, raw_j):
        assert a.shape == b.shape == (1, 8, 8, 1)
        np.testing.assert_allclose(a, b, rtol=0, atol=MAP_TOL)
    maps = np.stack(raw_j).reshape(2, len(IOU_PROMPTS), -1)  # (image, class, pixel)
    safe = (np.abs(maps - 0.8) > MAP_TOL).all(axis=(0, 2))
    assert safe.any()
    binary = maps >= 0.8
    assert binary.any() and not binary.all()  # the maps straddle the step
    np.testing.assert_array_equal(t_class[safe], j_class[safe])
    if safe.all():
        assert t_macro == j_macro


def _write_pairs(root, n: int, size: int, rng):
    from PIL import Image  # noqa: PLC0415

    img_dir, lbl_dir = root / "img", root / "lbl"
    img_dir.mkdir()
    lbl_dir.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.jpg")
        Image.fromarray(_labels(rng, 1, size)[0].astype(np.uint8), mode="L").save(
            lbl_dir / f"{i}.png")
    return img_dir, lbl_dir


def test_torch_evaluate_iou_cli(world, tmp_path, capsys):
    enc = Encoder4Editing(stylegan_size=SIZE, rng=torch.Generator().manual_seed(6))
    gen = torch.load(world["files"]["gen"])["g_ema"]
    sd = {f"encoder.{k}": v for k, v in enc.state_dict().items()}
    sd.update({f"decoder.{k}": v for k, v in gen.items()})
    e4e = tmp_path / "e4e.pt"
    torch.save({"state_dict": sd, "latent_avg": 0.1 * torch.randn(512)}, e4e)
    img_dir, lbl_dir = _write_pairs(tmp_path, 2, 64, np.random.default_rng(13))
    macro = evaluate.main(["iou", *_cli_args(world), "--e4e_ckpt", str(e4e),
                           "--img_path", str(img_dir), "--label_path", str(lbl_dir)])
    assert 0.0 <= macro <= 1.0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["per_class_iou"]) == 8 and out["macro_iou"] == macro
    assert all(0.0 <= v <= 1.0 for v in out["per_class_iou"])
    with pytest.raises(SystemExit, match="needs --e4e_ckpt"):
        evaluate.main(["iou", *_cli_args(world)])


def test_torch_celebamaskhq_loads_pairs(tmp_path):
    rng = np.random.default_rng(14)
    img_dir, lbl_dir = _write_pairs(tmp_path, 3, 32, rng)
    ds = CelebAMaskHQ(str(img_dir), str(lbl_dir))
    assert len(ds) == 3
    assert ds.pairs[2] == (os.path.join(img_dir, "2.jpg"), os.path.join(lbl_dir, "2.png"))
    img, lbl = ds.load(1, img_size=16, label_size=8)
    assert img.shape == (16, 16, 3) and img.dtype == np.float32
    assert -1.0 <= img.min() and img.max() <= 1.0
    assert lbl.shape == (8, 8) and lbl.dtype == np.int64
    from PIL import Image  # noqa: PLC0415

    full = np.asarray(Image.open(lbl_dir / "1.png"))
    assert set(np.unique(lbl)) <= set(np.unique(full))  # NEAREST: no new ids
    img, lbl = ds.load(0)
    assert img.shape == (256, 256, 3) and lbl.shape == (32, 32)
    assert len(CelebAMaskHQ(str(tmp_path / "missing"), str(lbl_dir))) == 0
