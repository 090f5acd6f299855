"""The port's e4e inversion against the benchmark's plain reference
(``port_bench/reference/e4e.py``), and the tracer's encoder and all-reduce
spans, on the CPU.

``Encoder4Editing`` at IR-SE 50 widths (stylegan_size 32: 8 W+ rows, 3
coarse, 4 middle, 1 fine; 64² photos, where c3 is 4²) is built from a
seeded reference-layout state dict through ``PSp.from_state_dict`` and run
through ``PSp.encode``, as the demo inverts a photo. Tolerance: max |Δ| /
max |ref| 1e-5, fp32 both sides: the port's BatchNorm and PReLU are
PyTorch's modules, the reference's their formulas, so a 24-unit residual
trunk rounds in another order (the gap reads ~4e-7).
"""

from __future__ import annotations

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench.reference import e4e as ref_e4e
from where2edit_tpu_torch.models.encoders import Encoder4Editing
from where2edit_tpu_torch.models.psp import PSp
from where2edit_tpu_torch.models.stylegan2 import Generator
from where2edit_tpu_torch.parallel import dist
from where2edit_tpu_torch.utils import profiling

SIZE = 32
TOL = 1e-5
ECFG = {"num_layers": 50, "mode": "ir_se", "stylegan_size": SIZE, "coarse_ind": 3,
        "middle_ind": 7, "start_from_latent_avg": True}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts six test processes on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


def seeded_state(seed: int) -> dict:
    """The e4e state dict (reference layout) drawn with ``seed``: convs
    N(0, 1/fan_in), linears N(0, 1), biases and running means 0.1 N(0, 1),
    running variances U(0.5, 1.5), BN scales 1 + 0.1 N(0, 1), PReLU slopes
    0.25 + 0.1 N(0, 1)."""
    with torch.device("meta"):
        layout = Encoder4Editing(stylegan_size=SIZE).state_dict()
    rng = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in layout.items():
        shape = tuple(v.shape)
        if not v.dtype.is_floating_point:
            sd[k] = torch.zeros(shape, dtype=v.dtype)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(shape, generator=rng)
        elif k.endswith(("running_mean", "bias")):
            sd[k] = 0.1 * torch.randn(shape, generator=rng)
        elif len(shape) == 4:
            sd[k] = torch.randn(shape, generator=rng) / math.sqrt(math.prod(shape[1:]))
        elif len(shape) == 2:
            sd[k] = torch.randn(shape, generator=rng)
        elif k.endswith(("input_layer.2.weight", "res_layer.2.weight")):
            sd[k] = 0.25 + 0.1 * torch.randn(shape, generator=rng)
        else:
            sd[k] = 1.0 + 0.1 * torch.randn(shape, generator=rng)
    return sd


@pytest.fixture(scope="module")
def psp_and_state():
    enc = seeded_state(7)
    with torch.device("meta"):
        decoder_keys = Generator(SIZE).state_dict()
    dec = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in decoder_keys.items()}
    avg = 0.3 * torch.randn(2 * int(math.log2(SIZE)) - 2, 512,
                            generator=torch.Generator().manual_seed(8))
    state = {f"encoder.{k}": v for k, v in enc.items()}
    state.update({f"decoder.{k}": v for k, v in dec.items()})
    psp = PSp.from_state_dict({"state_dict": state, "latent_avg": avg}, stylegan_size=SIZE,
                              device="cpu")
    photos = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(9)) * 2 - 1
    return psp, enc, avg, photos


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("stage", [18, 4, 1])  # every block (inference), partial, w0 + 1 delta
def test_torch_e4e_encode_matches_plain_reference(psp_and_state, stage):
    psp, enc, avg, photos = psp_and_state
    psp.encoder.progressive_stage = stage
    try:
        got = psp.encode(photos)
    finally:
        psp.encoder.progressive_stage = 18
    want = ref_e4e.encode(enc, dict(ECFG, progressive_stage=stage), photos, avg)
    assert got.shape == want.shape == (2, 8, 512)
    assert _rel(got, want) < TOL
    if stage < 7:  # the rows past the stage hold w0 (+ latent_avg) alone
        w0 = got[:, :1] - avg[:1]
        rest = got[:, stage + 1:] - avg[stage + 1:]
        assert torch.allclose(rest, w0.expand_as(rest), rtol=0.0, atol=1e-6)


def test_torch_e4e_encode_spans(psp_and_state):
    """Each encode records psp.encode once, with encoder.trunk and
    encoder.styles once each inside it; without a profiler nothing is
    recorded."""
    psp, _, _, photos = psp_and_state
    psp.encode(photos)
    assert profiling.TRACER.records == []
    with profile(activities=[ProfilerActivity.CPU]):
        psp.encode(photos)
        psp.encode(photos)
    totals = profiling.totals()
    assert {k: v["count"] for k, v in totals.items()} == {
        "psp.encode": 2, "encoder.trunk": 2, "encoder.styles": 2}
    by_id = {r.id: r for r in profiling.TRACER.records}
    for r in profiling.TRACER.records:
        if r.name != "psp.encode":
            assert by_id[r.parent].name == "psp.encode"


def _reduce_under_profiler(names: list) -> None:
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    with profile(activities=[ProfilerActivity.CPU]):
        dist.all_reduce_grads([p])
    names.extend(r.name for r in profiling.TRACER.records)
    assert torch.equal(p.grad, torch.full((3,), 2.0))  # the mean over one rank


def test_torch_all_reduce_grads_span_only_in_a_group(tmp_path):
    outside, inside = [], []
    _reduce_under_profiler(outside)
    assert outside == []
    profiling.reset()
    dist.launch(_reduce_under_profiler, 1, "cpu", inside, store_dir=str(tmp_path))
    assert inside == ["parallel.all_reduce_grads"]
