"""The face sources of the port's edit CLI and the gallery, on the CPU at
stylegan_size 32 (attention and cluster layer 7): ``--seed``, ``--image``
(a PNG through a random reference-layout e4e checkpoint), ``--latent``
(.npy and .pt banks), ``--celeb``; one token row per loaded face; the
refusals; ``CelebGallery``'s latent pack, image directory and built-in
faces; ``load_session``'s generator checkpoint."""

import argparse
import os
import types

import numpy as np
import pytest
import torch

from where2edit_tpu_torch.cli import edit
from where2edit_tpu_torch.demo.app import build_argparser, build_session, load_session
from where2edit_tpu_torch.demo.gallery import CelebGallery, read_face_images
from where2edit_tpu_torch.models.encoders import Encoder4Editing
from where2edit_tpu_torch.models.stylegan2 import Generator

SIZE, LAYER, N_LATENT = 32, 7, 8
BASE = ["--stylegan_size", str(SIZE), "--attention_layer", str(LAYER),
        "--cluster_layer", str(LAYER), "--device", "cpu", "--ckpt", "none"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts six test processes on the
    machine's cores, where more threads per process spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def session():
    return build_session(SIZE, LAYER, LAYER, device="cpu")


def _run(tmp_path, *argv):
    return edit.main([*BASE, "--output_dir", str(tmp_path / "out"), *argv])


def _bank(faces: int) -> np.ndarray:
    return np.random.default_rng(faces).standard_normal(
        (faces, N_LATENT, 512)).astype(np.float32)


@pytest.mark.parametrize("fmt", ["npy", "npz", "pt", "pt_dict", "npy_one_face"])
def test_torch_edit_cli_latent_bank(tmp_path, fmt):
    """A W+ bank of 2 faces and 2 prompts: one row (and one PNG) per
    (prompt, face); a single (n_latent, 512) face is a bank of one."""
    faces = 1 if fmt == "npy_one_face" else 2
    bank = _bank(2)
    path = tmp_path / f"bank.{fmt.split('_')[0]}"
    if fmt == "npy":
        np.save(path, bank)
    elif fmt == "npy_one_face":
        np.save(path, bank[0])
    elif fmt == "npz":
        np.savez(path, latents=bank)
    elif fmt == "pt":
        torch.save(torch.from_numpy(bank), path)
    else:
        torch.save({"latents": torch.from_numpy(bank)}, path)
    assert edit._load_wplus_bank(str(path)).shape == (faces, N_LATENT, 512)
    rows = _run(tmp_path, "--latent", str(path), "--text", "grey hair", "red lips")
    assert [(r["text"], r["face"]) for r in rows] == [
        (t, f) for t in ("grey hair", "red lips") for f in range(faces)]
    for r in rows:
        assert os.path.exists(r["edit"]) and os.path.exists(r["attention_map"])


def test_torch_edit_cli_image(tmp_path):
    """A photo through e4e: a random reference-layout checkpoint holding
    encoder.*, decoder.* and latent_avg."""
    from PIL import Image  # noqa: PLC0415

    rng = torch.Generator().manual_seed(0)
    enc = Encoder4Editing(stylegan_size=SIZE, rng=rng)
    dec = Generator(SIZE, rng=rng)
    state = {**{f"encoder.{k}": v for k, v in enc.state_dict().items()},
             **{f"decoder.{k}": v for k, v in dec.state_dict().items()}}
    torch.save({"state_dict": state, "latent_avg": torch.randn(N_LATENT, 512)},
               tmp_path / "e4e.pt")
    pixels = np.random.default_rng(0).integers(0, 256, (40, 48, 3), np.uint8)
    Image.fromarray(pixels).save(tmp_path / "face.png")
    x = read_face_images([tmp_path / "face.png"])
    assert tuple(x.shape) == (1, 256, 256, 3)
    assert float(x.min()) >= -1.0 and float(x.max()) <= 1.0
    rows = _run(tmp_path, "--image", str(tmp_path / "face.png"), "--e4e_ckpt",
                str(tmp_path / "e4e.pt"), "--text", "grey hair")
    assert [(r["text"], r["face"]) for r in rows] == [("grey hair", 0)]
    assert os.path.exists(tmp_path / "out" / "original.png")


def test_torch_edit_cli_celeb(tmp_path, capsys):
    assert _run(tmp_path, "--celeb", "list") == []
    assert capsys.readouterr().out.split("\n")[:5] == [f"Celeb {i}" for i in range(1, 6)]
    rows = _run(tmp_path, "--celeb", "Celeb 1", "--text", "grey hair")
    assert [(r["text"], r["face"]) for r in rows] == [("grey hair", 0)]


def test_torch_edit_cli_seed_sweep(tmp_path):
    """--batch_prompts with one face: the prompts run as one batch."""
    rows = _run(tmp_path, "--seed", "3", "--text", "grey hair", "red lips",
                "--batch_prompts")
    assert [(r["text"], r["face"]) for r in rows] == [("grey hair", 0), ("red lips", 0)]


@pytest.mark.parametrize("argv,message", [
    (["--text", "a", "b", "--batch_prompts", "--latent", "BANK"], "single-face"),
    (["--text", "a", "--image", "face.png"], "requires --e4e_ckpt"),
    (["--celeb", "Celeb 1"], "--text is required"),
])
def test_torch_edit_cli_refusals(tmp_path, argv, message):
    np.save(tmp_path / "bank.npy", _bank(2))
    argv = [str(tmp_path / "bank.npy") if a == "BANK" else a for a in argv]
    with pytest.raises(SystemExit, match=message):
        _run(tmp_path, *argv)


def test_torch_gallery_latent_pack(tmp_path, session):
    w = torch.randn(N_LATENT, 512)
    torch.save({"Portrait A": w, "Portrait B": torch.randn(1, N_LATENT, 512)},
               tmp_path / "celebs.pt")
    g = CelebGallery(session, celebs_path=str(tmp_path / "celebs.pt"))
    assert g.names() == ["Portrait A", "Portrait B"]
    img = g.load("Portrait A")
    assert tuple(img.shape) == (1, SIZE, SIZE, 3)
    assert torch.equal(img, session.load_latent(w[None]))
    torch.save(torch.randn(3, N_LATENT, 512), tmp_path / "pack.pt")
    g2 = CelebGallery(session, celebs_path=str(tmp_path / "pack.pt"))
    assert g2.names() == ["Celeb 1", "Celeb 2", "Celeb 3"]
    assert tuple(g2.load("Celeb 3").shape) == (1, SIZE, SIZE, 3)


def test_torch_gallery_images_dir_needs_encoder(tmp_path, session):
    from PIL import Image  # noqa: PLC0415

    Image.new("RGB", (64, 64), (128, 64, 32)).save(tmp_path / "Sitter.png")
    g = CelebGallery(session, images_dir=str(tmp_path))
    assert g.names() == ["Sitter"]
    with pytest.raises(RuntimeError, match="e4e"):
        g.load("Sitter")
    seen = []

    def encode(x):
        seen.append(tuple(x.shape))
        return torch.zeros(1, N_LATENT, 512)

    psp = types.SimpleNamespace(encode=encode, device=torch.device("cpu"))
    img = CelebGallery(session, images_dir=str(tmp_path), psp=psp).load("Sitter")
    assert seen == [(1, 256, 256, 3)] and tuple(img.shape) == (1, SIZE, SIZE, 3)


def test_torch_gallery_builtin_faces(session):
    g = CelebGallery(session)
    assert g.names() == [f"Celeb {i}" for i in range(1, 6)]
    a = g.load("Celeb 2")
    assert torch.equal(a, g.load("Celeb 2"))
    assert torch.equal(a, session.load_synthetic(1001))
    with pytest.raises(KeyError, match="unknown gallery entry"):
        g.load("nobody")


def test_torch_load_session_generator_ckpt(tmp_path):
    """--ckpt's g_ema loads into the session's generator; a missing file
    leaves the seeded weights; no --e4e_ckpt gives no encoder."""
    from where2edit_tpu_torch.demo.app import load_psp  # noqa: PLC0415

    g_ema = Generator(SIZE, rng=torch.Generator().manual_seed(5)).state_dict()
    torch.save({"g_ema": g_ema}, tmp_path / "g.pt")
    args = build_argparser().parse_args([*BASE[:-1], str(tmp_path / "g.pt")])
    loaded = load_session(args).generator.state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in g_ema.items())
    seeded = load_session(argparse.Namespace(**{**vars(args), "ckpt": "none"}))
    assert not torch.equal(seeded.generator.state_dict()["conv1.conv.weight"],
                           g_ema["conv1.conv.weight"])
    assert load_psp(args) is None
