"""The FLOP and byte counts against hand counts of config-f."""

from __future__ import annotations

import pytest

from port_bench.lib import spec
from port_bench.work import edit as work_edit
from port_bench.work import gan as work_gan
from port_bench.work import stylegan2 as sg


def _cfg(name):
    return spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")


def test_port_bench_config_f_hand_counts():
    g = _cfg("stylegan2-ffhq1024-f")["generator"]
    m = sg.synthesis_macs(g)
    # 3x3, transposed and ToRGB convs of one 1024² image: 74.26 GMAC
    assert (m["conv"] + m["torgb"]) / 1e9 == pytest.approx(74.26, abs=0.005)
    d = sg.discriminator_macs(_cfg("stylegan2-ffhq1024-f")["discriminator"])
    assert d["conv"] / 1e9 == pytest.approx(76.67, abs=0.005)
    assert len(sg.k1_calls(g)) == 9 and len(sg.k2_calls(g)) == 9
    assert sg.k2_calls(g)[-1] == (4, 513, 512)


def test_port_bench_work_per_unit():
    w2e = _cfg("w2e-sspace-ffhq1024")
    e = work_edit.per_edit(w2e, {"batch": 8})
    syn = sg.synthesis_flops(w2e["generator"])
    assert 2 * syn < e["flops_per_unit"] < 2.2 * syn
    nbytes, flops = sg.conv3x3_call(8, 1024, 32, 32)
    assert flops == 2 * 8 * 1024 * 1024 * 32 * 32 * 9
    assert e["kernel_bound_s_per_unit"]["k1"] > 0
    gan = _cfg("stylegan2-ffhq1024-f")
    t = work_gan.per_sample(gan, {"batch": 8})
    # G once, D six times in d; G three times, D twice in g; R1 and path amortised
    lo = 4 * sg.synthesis_flops(gan["generator"]) + 8 * sg.discriminator_flops(
        gan["discriminator"])
    assert lo < t["flops_per_unit"] < 1.2 * lo
    # the launch counters on the card: 54 per iteration, 35 more per R1
    assert t["kernel_calls_per_step"]["k2"] == pytest.approx(54 + 35 / 16)
    assert t["kernel_calls_per_step"]["k1"] == pytest.approx(27 + 35 / 4)
