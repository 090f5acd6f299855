"""``--mapper`` and ``--clip_ckpt`` on the CPU at stylegan_size 32
(attention and cluster layer 7): the files a user brings load through
``demo/app.py::load_session`` and ``cli/edit.py`` as the JAX loader reads
them.

- A reference ``.pt`` with DDP ``module.`` keys and the dead
  ``mapper_textca_{c}`` (CA_NET) entries, and the port's own
  ``final_mapper.pt`` (its ``"mapper"`` entry): an edit equals, bitwise,
  the edit of a session holding the same mapper in memory, and differs from
  the random-mapper edit. The JAX reader (``convert_feat_cluster_lin_style``)
  reads the same file to the same weights.
- A ``.pt`` without ``initial_state``: it loads, and, as the JAX mapper
  without its clusters collection, the edit refuses.
- A file that is no mapper checkpoint, or another mapper's, is an error
  naming the file.
- ``--clip_ckpt`` loads the text tower from an OpenAI-layout state dict.
"""

import numpy as np
import pytest
import torch

from where2edit_tpu.convert.mappers import convert_feat_cluster_lin_style
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.cli import edit
from where2edit_tpu_torch.demo.app import (
    build_argparser,
    build_session,
    load_session,
    read_mapper_checkpoint,
)
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLin,
    FullSpaceMapperFEATClusterLinStyle,
)
from where2edit_tpu_torch.models.clip_model import CLIP
from where2edit_tpu_torch.models.clip_tokenizer import tokenize

from torch_parity import TINY_CLIP, np_tree

SIZE, LAYER, N_LATENT = 32, 7, 8
BASE = ["--stylegan_size", str(SIZE), "--attention_layer", str(LAYER),
        "--cluster_layer", str(LAYER), "--device", "cpu", "--ckpt", "none"]
PROMPT, REGION = tokenize(["a person with grey hair"]), tokenize(["grey hair"])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A trained-looking mapper (its own seed, non-zero centres) written as
    a DDP reference .pt with CA_NET entries, the same without
    ``initial_state``, and as the port's training checkpoint."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("mappers")
    rng = torch.Generator().manual_seed(11)
    mapper = FullSpaceMapperFEATClusterLinStyle(
        layers=N_LATENT, attention_layer=LAYER, cluster_layer=LAYER,
        generator_size=SIZE, clusters=6, cluster_dim=576, rng=rng)
    with torch.no_grad():
        mapper.initial_state.copy_(torch.randn(6, 576, generator=rng))
        mapper.initial_bias.fill_(0.5)
    sd = mapper.state_dict()
    ref = {f"module.{k}": v for k, v in sd.items()}
    for c in range(mapper.mapper_layer):
        ref[f"module.mapper_textca_{c}.fc.weight"] = torch.randn(2048, 512, generator=rng)
        ref[f"module.mapper_textca_{c}.fc.bias"] = torch.zeros(2048)
    torch.save(ref, root / "ref.pt")
    torch.save({k: v for k, v in ref.items() if not k.endswith("initial_state")},
               root / "no_centres.pt")
    torch.save({"mapper": sd, "adam": {"count": 3}, "step": 3,
                "rng": torch.Generator().get_state(), "opts": {}},
               root / "final_mapper.pt")
    torch.save({"state_dict": {f"mapper.{k}": v for k, v in sd.items()}},
               root / "wrapped.pt")
    torch.save({"step": 3}, root / "not_a_mapper.pt")
    wplus = FullSpaceMapperFEATClusterLin(layers=N_LATENT, attention_layer=LAYER,
                                          cluster_layer=LAYER, generator_size=SIZE)
    torch.save({"mapper": wplus.state_dict()}, root / "wplus_mapper.pt")
    clip = CLIP(**TINY_CLIP, rng=torch.Generator().manual_seed(12))
    torch.save(clip.state_dict(), root / "clip.pt")
    return {"root": root, "mapper": mapper, "clip": clip}


def _args(*extra):
    return build_argparser().parse_args([*BASE, *extra])


def _edit(session):
    session.load_synthetic(4)
    return session.edit(PROMPT, REGION, strength_alpha=0.3)


def test_torch_reference_mapper_state_dict_quirks(files):
    ref = torch.load(files["root"] / "ref.pt", weights_only=True)
    sd = convert.reference_mapper_state_dict(ref)
    assert set(sd) == set(files["mapper"].state_dict())
    assert not any(k.startswith(("module.", "mapper_textca_")) for k in sd)
    no_centres = convert.reference_mapper_state_dict(
        torch.load(files["root"] / "no_centres.pt", weights_only=True))
    assert set(sd) - set(no_centres) == {"initial_state"}


def test_torch_reference_mapper_read_as_jax_reads_it():
    """The JAX reader of reference checkpoints (its 1024² tap list, so at
    1024², no forward) reads a DDP file with CA_NET entries to the weights
    the port's reader gives, bitwise, and every one of them."""
    mapper = FullSpaceMapperFEATClusterLinStyle(
        layers=18, attention_layer=13, cluster_layer=13,
        rng=torch.Generator().manual_seed(13))
    ref = {f"module.{k}": v for k, v in mapper.state_dict().items()}
    ref["module.mapper_textca_0.fc.weight"] = torch.ones(4, 4)
    sd = convert.reference_mapper_state_dict(ref)
    back = convert.mapper_state_dict(
        np_tree(convert_feat_cluster_lin_style(ref, attention_layer=13)))
    assert set(back) == set(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("name", ["ref.pt", "final_mapper.pt", "wrapped.pt"])
def test_torch_load_session_mapper_files(files, name):
    session = load_session(_args("--mapper", str(files["root"] / name)))
    for k, v in files["mapper"].state_dict().items():
        assert torch.equal(session.mapper.state_dict()[k], v), k
    assert session.mapper.clusters == 6
    img, amap = _edit(session)
    held = build_session(SIZE, LAYER, LAYER, device="cpu")
    random_img, random_map = _edit(held)
    held.mapper = files["mapper"].eval()
    want_img, want_map = _edit(held)
    assert torch.equal(img, want_img) and torch.equal(amap, want_map)
    assert not torch.equal(img, random_img)


def test_torch_load_session_mapper_without_centres(files):
    """The JAX loader reads such a file, and its mapper then has no
    clusters collection and refuses to run; so does the port's."""
    session = load_session(_args("--mapper", str(files["root"] / "no_centres.pt")))
    assert session.mapper.initial_state is None
    assert "initial_state" not in session.mapper.state_dict()
    assert torch.equal(session.mapper.attention_last.conv.weight,
                       files["mapper"].attention_last.conv.weight)
    with pytest.raises(RuntimeError, match="no k-means centres"):
        _edit(session)


@pytest.mark.parametrize("name,message", [
    ("not_a_mapper.pt", "neither a mapper state dict"),
    ("wplus_mapper.pt", "does not fit FullSpaceMapperFEATClusterLinStyle"),
])
def test_torch_load_session_refuses_other_files(files, name, message):
    path = str(files["root"] / name)
    with pytest.raises(ValueError, match=message) as e:
        read_mapper_checkpoint(path) if name == "not_a_mapper.pt" else \
            load_session(_args("--mapper", path))
    assert path in str(e.value)


def test_torch_load_session_clip_ckpt_and_warnings(files, capsys):
    session = load_session(_args("--clip_ckpt", str(files["root"] / "clip.pt")))
    err = capsys.readouterr().err
    assert "no --mapper" in err and "no --clip_ckpt" not in err
    toks = torch.as_tensor(np.asarray(PROMPT)).long()
    with torch.no_grad():
        want = files["clip"].encode_text(toks)
    text, _ = session.encode(PROMPT)
    assert torch.equal(text, want)
    load_session(_args("--mapper", str(files["root"] / "ref.pt")))
    err = capsys.readouterr().err
    assert "no --clip_ckpt" in err and "no --mapper" not in err


def test_torch_edit_cli_mapper_changes_the_image(files, tmp_path):
    from PIL import Image  # noqa: PLC0415

    def run(out, *extra):
        rows = edit.main([*BASE, "--seed", "2", "--text", "grey hair",
                          "--strength", "0.3", "--coverage", "1", "--output_dir", str(tmp_path / out),
                          *extra])
        return np.asarray(Image.open(rows[0]["edit"]))

    random_img = run("random")
    trained = run("trained", "--mapper", str(files["root"] / "final_mapper.pt"))
    again = run("again", "--mapper", str(files["root"] / "ref.pt"))
    assert trained.shape == (SIZE, SIZE, 3)
    assert not np.array_equal(trained, random_img)
    assert np.array_equal(trained, again)
