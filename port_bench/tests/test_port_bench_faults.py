"""A run whose timed path is broken underneath comes out not correct: the
whole run on the CPU at a tiny size (past the look for a card), with one
fault planted in the program at a time."""

from __future__ import annotations

import pytest
import torch

from port_bench import run
from port_bench.tests.conftest import ATT_CPU, EDIT_CPU, GAN_CPU
from where2edit_tpu_torch.demo.api import EditSession
from where2edit_tpu_torch.train import attention_trainer, gan_trainer


def _correct(workload, sizes):
    out = run.run(["--workload", workload, "--seed", "2200000003", "--seconds", "0.5",
                   "--trace", "0"], device="cpu", **sizes)
    return out["correct"]


def _altered_answer(monkeypatch):
    render = EditSession.render

    def wrong(self, new_latents, amap):
        img = render(self, new_latents, amap).clone()
        img[0] += 0.1 * img[0].abs().max()
        return img

    monkeypatch.setattr(EditSession, "render", wrong)


def _altered_token(monkeypatch):
    init = EditSession.__init__

    def wrong(self, **kw):
        encode = kw["clip_encode_text"]
        kw["clip_encode_text"] = lambda t: encode(torch.roll(t, 1, 0))
        init(self, **kw)

    monkeypatch.setattr(EditSession, "__init__", wrong)


def _state_unchanged(monkeypatch):
    load = EditSession.load_latent
    calls = []

    def stale(self, wplus):  # every capture after the first keeps the first face
        calls.append(1)
        return load(self, wplus) if len(calls) == 1 else self.image

    monkeypatch.setattr(EditSession, "load_latent", stale)


@pytest.mark.parametrize("fault", [_altered_answer, _altered_token, _state_unchanged])
def test_port_bench_edit_fault_is_not_correct(monkeypatch, fault):
    assert _correct("edit-b8", EDIT_CPU)
    fault(monkeypatch)
    assert not _correct("edit-b8", EDIT_CPU)


def _step_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    d_loss, g_loss = gan_trainer.logistic_d_loss, gan_trainer.logistic_g_loss
    monkeypatch.setattr(gan_trainer, "logistic_d_loss",
                        lambda r, f: d_loss(r[: len(r) // 2], f[: len(f) // 2]))
    monkeypatch.setattr(gan_trainer, "logistic_g_loss", lambda f: g_loss(f[: len(f) // 2]))


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch])
def test_port_bench_gan_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not _correct("gan-train-b8", GAN_CPU)


def _mapper_unchanged(monkeypatch):
    monkeypatch.setattr(attention_trainer.MapperAdam, "step", lambda self, grads: None)


def _mapper_half_batch(monkeypatch):
    infonce = attention_trainer.infonce_consistency
    monkeypatch.setattr(attention_trainer, "infonce_consistency",
                        lambda a, b, **kw: infonce(a[: len(a) // 2], b[: len(b) // 2], **kw))


@pytest.mark.parametrize("fault", [_mapper_unchanged, _mapper_half_batch])
def test_port_bench_mapper_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not _correct("mapper-train-b8", ATT_CPU)
