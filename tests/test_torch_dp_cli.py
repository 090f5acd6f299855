"""The port's five data-parallel CLIs on the CPU: ``--dp 2`` (``--use_mesh``
for ``cli/mapper_train.py``) over two gloo ranks against ``--dp 0``, at toy
sizes, and the checkpoints, ``--resume`` and SIGTERM in a group.

One pair of rank processes is spawned for the module (``parallel.launch``,
a ``file://`` store under the module's temporary directory). Each rank
calls every CLI's ``main`` with ``--dp 2``, which runs it in the group the
pair already forms (as under ``torchrun`` with ``--multihost``); this
process runs the same CLIs with ``--dp 0`` meanwhile. Bars:

- ``train_stylegan``: every metric of every iteration at rtol 1e-5, G, D
  and G_ema at atol 5·lr and ``pl_mean`` at 1e-6 (tests/test_torch_parallel.py's
  bars); each checkpoint written by rank 0 alone, no ``.tmp*`` left;
  ``--resume`` of the step-1 checkpoint on both ranks ends bit for bit where
  the uninterrupted two-rank run ends; a SIGTERM sent to rank 1 alone stops
  both ranks at the same step, with one checkpoint.
- ``run_attention``: every logged loss term of every step at 1e-5.
- ``run_clustering``: the centres bitwise, at a batch of 4 (2 rows per
  rank: the CPU's convolutions take another algorithm at batch 1 than at
  batch 2, 7.9e-6 apart in the tap, and are bitwise alike from batch 2 on).
  Both sides fit on one thread: sklearn's multithreaded ``KMeans`` adds its
  threads' partial sums in the order they take a lock, so two fits of one
  matrix may differ in the last bit.
- ``evaluate edits``: the JSON line's values at 1e-5.
- ``mapper_train --use_mesh``: the logged losses of each step and the
  validation loss at 1e-4 relative (tests/test_torch_coach.py's bar).
- the JAX CLIs' two refusals: ``--dp N exceeds the M available devices``
  and ``--batch B not divisible by --dp N``.
"""

import json
import os
import signal
import sys
import threading

import numpy as np
import pytest
import torch

from where2edit_tpu_torch.cli import (
    evaluate,
    mapper_train,
    run_attention,
    run_clustering,
    train_stylegan,
)
from where2edit_tpu_torch.models.clip_model import CLIP
from where2edit_tpu_torch.models.vgg import Vgg16
from where2edit_tpu_torch.parallel import dist
from where2edit_tpu_torch.utils.logging import read_scalars

from torch_parity import TINY_CLIP

LR = 0.002
GAN = ["--synthetic", "6", "--size", "8", "--batch", "4", "--device", "cpu",
       "--d_reg_every", "2", "--g_reg_every", "2", "--lr", str(LR), "--sample_every", "0"]


class GanProbe:
    """``train_stylegan``'s span: each iteration's metrics (read at its
    ``ema`` program, after they are the global batch's); with ``kill_at``,
    the rank sends itself SIGTERM as that step's ``d`` program starts."""

    def __init__(self, kill_at=None):
        self.metrics, self.kill_at, self.last_step = [], kill_at, None

    def __call__(self, program, trainer):
        import contextlib  # noqa: PLC0415

        @contextlib.contextmanager
        def span():
            if program == "d" and trainer.global_step == self.kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield
            if program == "ema":
                self.metrics.append({k: float(v) for k, v in trainer.metrics.items()})
                self.last_step = trainer.global_step
        return span()


def gan_run(out: str, *extra, kill_at=None) -> dict:
    probe = GanProbe(kill_at)
    result = train_stylegan.main([*GAN, "--results_dir", out, *extra], span=probe)
    return {"metrics": probe.metrics, "returned": result is not None,
            "last_step": probe.last_step}


def attention_run(a: dict, out: str, *extra) -> list:
    run_attention.main(["--stylegan_size", "32", "--device", "cpu", "--work_in_stylespace",
                        "--use_cluster", "--cluster_path", a["pkl"], "--cluster_layer", "7",
                        "--clip_ckpt", a["clip"], "--vgg_ckpt", a["vgg"],
                        "--ckpt", "/nonexistent", "--results_dir", out, "--step", "2",
                        "--batch_size", "2", "--save_intermediate_image_every", "0",
                        "--own_description_dir", "/nonexistent", *extra])
    logs = os.path.join(out, "logs")  # rank 0's alone in a group
    return read_scalars(os.path.join(logs, os.listdir(logs)[0])) if os.path.isdir(logs) else []


def clustering_run(out: str, *extra) -> str:
    from threadpoolctl import threadpool_limits  # noqa: PLC0415

    with threadpool_limits(1):
        return run_clustering.main(["--stylegan_size", "32", "--device", "cpu",
                                    "--attention_layer", "7", "--batch_size", "4",
                                    "--step", "2", "--results_dir", out,
                                    "--ckpt", "/nonexistent", *extra])


def evaluate_run(a: dict, *extra):
    return evaluate.main(["edits", "--device", "cpu", "--stylegan_size", "32",
                          "--attention_layer", "4", "--cluster_layer", "4",
                          "--iterations", "2", "--batch", "2", "--clip_ckpt", a["clip"],
                          "--ckpt", "/nonexistent", "--description_dir", "/nonexistent",
                          *extra])


def mapper_run(a: dict, exp: str, *extra) -> list:
    mapper_train.main(["--exp_dir", exp, "--description", "purple hair",
                       "--stylegan_size", "32", "--stylegan_weights", "/nonexistent",
                       "--clip_ckpt", a["clip"], "--id_lambda", "0", "--max_steps", "1",
                       "--batch_size", "2", "--train_dataset_size", "4",
                       "--test_dataset_size", "2", "--val_interval", "1",
                       "--board_interval", "1", "--device", "cpu", *extra])
    logs = os.path.join(exp, "logs")  # rank 0's alone in a group
    return read_scalars(logs) if os.path.isfile(os.path.join(logs, "metrics.jsonl")) else []


def _cli_worker(root: str) -> None:
    """A rank of the pair: every CLI with ``--dp 2``; which files each
    rank's ``torch.save`` wrote; the results to ``cli_rank<r>.pt``."""
    torch.set_num_threads(2)
    sys.modules["torch.utils.tensorboard"] = None  # no TensorFlow import
    with open(os.path.join(root, "assets.json")) as f:
        a = json.load(f)
    saves, save = [], torch.save

    def counting_save(obj, path, *args, **kw):
        saves.append(os.path.relpath(str(path), root))
        return save(obj, path, *args, **kw)

    torch.save = counting_save
    try:
        out = {
            "gan": gan_run(f"{root}/gan_dp", "--iter", "2", "--save_every", "1", "--dp", "2"),
            "resumed": gan_run(f"{root}/gan_dp_resumed", "--iter", "2", "--save_every", "1",
                               "--resume", f"{root}/gan_dp/ckpt_0000001.pt", "--dp", "2"),
            "sigterm": gan_run(f"{root}/gan_dp_sigterm", "--iter", "4", "--save_every", "0",
                               "--dp", "2", kill_at=1 if dist.rank() == 1 else None),
            "attention": attention_run(a, f"{root}/att_dp", "--dp", "2"),
            "clustering": clustering_run(f"{root}/k_dp", "--dp", "2"),
            "evaluate": evaluate_run(a, "--dp", "2"),
            "mapper": mapper_run(a, f"{root}/mapper_dp", "--use_mesh"),
        }
    finally:
        torch.save = save
    out["saves"] = saves
    save(out, os.path.join(root, f"cli_rank{dist.rank()}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({name: the --dp 0 run}, [each rank's results], the directory)."""
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    root = str(tmp_path_factory.mktemp("dp_cli"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # no TensorFlow import
        clip = f"{root}/clip.pt"
        torch.save(CLIP(**TINY_CLIP, rng=torch.Generator().manual_seed(1)).state_dict(), clip)
        vgg = Vgg16(rng=torch.Generator().manual_seed(2))
        torch.save({**vgg.state_dict(), "classifier.0.bias": torch.zeros(4)},
                   f"{root}/vgg16.pth")
        a = {"clip": clip, "vgg": f"{root}/vgg16.pth",
             "pkl": clustering_run(f"{root}/k_single")}
        with open(f"{root}/assets.json", "w") as f:
            json.dump(a, f)
        failed = []

        def pair():
            try:
                dist.launch(_cli_worker, 2, "cpu", root, store_dir=root, timeout_s=600)
            except BaseException as e:  # re-raised below
                failed.append(e)

        thread = threading.Thread(target=pair)
        thread.start()
        single = {"gan": gan_run(f"{root}/gan_single", "--iter", "2", "--save_every", "1"),
                  "attention": attention_run(a, f"{root}/att_single"),
                  "clustering": a["pkl"], "evaluate": evaluate_run(a),
                  "mapper": mapper_run(a, f"{root}/mapper_single")}
        thread.join()
    if failed:
        raise failed[0]
    ranks = [torch.load(f"{root}/cli_rank{r}.pt", weights_only=False) for r in range(2)]
    return single, ranks, root


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_torch_dp_cli_train_stylegan_matches_dp0(runs):
    single, ranks, root = runs
    for r in ranks:
        assert r["gan"]["returned"] and len(r["gan"]["metrics"]) == 2
        for m, w in zip(r["gan"]["metrics"], single["gan"]["metrics"]):
            assert set(m) == set(w)
            for k, v in w.items():
                np.testing.assert_allclose(m[k], v, rtol=1e-5, err_msg=k)
    want, got = _load(f"{root}/gan_single/ckpt_0000002.pt"), _load(f"{root}/gan_dp/ckpt_0000002.pt")
    for part in ("g", "d", "g_ema"):
        for name, v in want[part].items():
            np.testing.assert_allclose(got[part][name], v, rtol=0, atol=5 * LR,
                                       err_msg=f"{part}.{name}")
    np.testing.assert_allclose(float(got["pl_mean"]), float(want["pl_mean"]), rtol=1e-6)


def test_torch_dp_cli_checkpoints_written_once_by_rank0(runs):
    _, ranks, root = runs
    # every interval's checkpoint and the final one (the last interval's file
    # again), each staged under a name of the writing process's own
    ckpts = ["gan_dp/ckpt_0000001.pt", "gan_dp/ckpt_0000002.pt", "gan_dp/ckpt_0000002.pt",
             "gan_dp_resumed/ckpt_0000002.pt", "gan_dp_resumed/ckpt_0000002.pt",
             "gan_dp_sigterm/ckpt_0000002.pt"]
    gan = [s for s in ranks[0]["saves"] if s.startswith("gan_")]
    assert [s.split(".tmp.")[0] for s in gan] == ckpts
    assert all(s.split(".tmp.")[1].isdigit() for s in gan)
    assert ranks[1]["saves"] == []  # rank 1 writes nothing, anywhere
    for d in ("gan_dp", "gan_dp_resumed", "gan_dp_sigterm", "att_dp", "mapper_dp"):
        for _, _, files in os.walk(os.path.join(root, d)):
            assert not [f for f in files if ".tmp" in f], (d, files)
    assert sorted(os.listdir(f"{root}/gan_dp")) == ["ckpt_0000001.pt", "ckpt_0000002.pt",
                                                     "logs"]


def test_torch_dp_cli_resume_is_bit_exact(runs):
    _, ranks, root = runs
    assert all(r["resumed"]["returned"] and len(r["resumed"]["metrics"]) == 1 for r in ranks)
    want = _load(f"{root}/gan_dp/ckpt_0000002.pt")
    got = _load(f"{root}/gan_dp_resumed/ckpt_0000002.pt")
    for part in ("g", "d", "g_ema"):
        for name, v in want[part].items():
            assert torch.equal(got[part][name], v), (part, name)
    assert torch.equal(got["pl_mean"], want["pl_mean"]) and torch.equal(got["rng"], want["rng"])


def test_torch_dp_cli_sigterm_to_one_rank_stops_both(runs):
    _, ranks, root = runs
    for r in ranks:  # both ranks finished step 1, checkpointed at 2 and returned None
        assert not r["sigterm"]["returned"] and r["sigterm"]["last_step"] == 1
    assert sorted(os.listdir(f"{root}/gan_dp_sigterm")) == ["ckpt_0000002.pt", "logs"]
    assert _load(f"{root}/gan_dp_sigterm/ckpt_0000002.pt")["step"] == 2


def test_torch_dp_cli_run_attention_matches_dp0(runs):
    single, ranks, _ = runs
    want = {(s["tag"], s["step"]): s["value"] for s in single["attention"]}
    got = {(s["tag"], s["step"]): s["value"] for s in ranks[0]["attention"]}
    assert set(got) == set(want) and {step for _, step in want} == {0, 1}
    for key, w in want.items():
        assert abs(got[key] - w) <= 1e-5 * max(abs(w), 1e-6), (key, got[key], w)
    assert len(ranks[0]["attention"]) == len(got)  # each written once, by rank 0


def test_torch_dp_cli_run_clustering_centres_bitwise(runs):
    import pickle  # noqa: PLC0415

    single, ranks, root = runs
    with open(single["clustering"], "rb") as f:
        want = pickle.load(f)
    with open(ranks[0]["clustering"], "rb") as f:
        got = pickle.load(f)
    assert ranks[0]["clustering"].startswith(f"{root}/k_dp")
    assert np.array_equal(got, want)


def test_torch_dp_cli_evaluate_edits_matches_dp0(runs):
    single, ranks, _ = runs
    want, got = single["evaluate"], ranks[0]["evaluate"]
    assert ranks[1]["evaluate"] is None  # rank 0 alone prints and returns
    assert set(got) == set(want) and got["n"] == want["n"] == 4
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_torch_dp_cli_mapper_train_use_mesh_matches(runs):
    single, ranks, _ = runs
    want = {(s["tag"], s["step"]): s["value"] for s in single["mapper"]}
    got = {(s["tag"], s["step"]): s["value"] for s in ranks[0]["mapper"]}
    assert set(got) == set(want)
    assert {("train/loss", 0), ("train/loss", 1), ("test/loss", 1)} <= set(want)
    for key, w in want.items():
        if key[0].endswith("step_time"):
            continue
        assert abs(got[key] - w) <= 1e-4 * max(abs(w), 1e-6), (key, got[key], w)


def test_torch_dp_cli_refusals():
    with pytest.raises(SystemExit, match=r"--dp 100000 exceeds the \d+ available devices"):
        train_stylegan.main([*GAN, "--iter", "1", "--dp", "100000"])
    with pytest.raises(SystemExit, match="--batch 3 not divisible by --dp 2"):
        train_stylegan.main([*GAN[:4], "--batch", "3", *GAN[6:], "--dp", "2"])
    with pytest.raises(SystemExit, match="--batch_size 3 not divisible by --dp 2"):
        run_clustering.main(["--stylegan_size", "32", "--device", "cpu",
                             "--batch_size", "3", "--dp", "2"])
