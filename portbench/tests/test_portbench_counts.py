"""The frozen operation counts at the flagship widths, and their agreement
with the program's own layer plan today."""

import pytest

from portbench import catalog, counts

FLAGSHIP = catalog.config("deepsdf-8x512-eik")["specs"]


def test_k1_macs_per_point():
    # 3 x 512 (xyz, layer 0) + 2 x 512^2 + 512 x 253 + 256 x 512 (layer 4:
    # 253 hidden + 3 xyz) + 3 x 512^2 + 512
    assert counts.point_macs(FLAGSHIP) == 1_573_376


def test_k2_b_flops_per_point():
    assert counts.k2_flops(FLAGSHIP, 1) == pytest.approx(18.88e6, rel=1e-3)
    assert counts.k2_flops(FLAGSHIP, 1) == 2 * 6 * 1_573_376


def test_fit_flops_per_point():
    assert counts.input_grad_macs(FLAGSHIP) == 1_570_304
    assert counts.fit_flops(FLAGSHIP, 1) == pytest.approx(6.29e6, rel=1e-3)


def test_least_time_of_a_flagship_step():
    n = 32 * 16384
    least = counts.least_seconds(counts.k2_flops(FLAGSHIP, n), counts.k2_io_bytes(FLAGSHIP, 32, 16384), "bfloat16")
    assert least == pytest.approx(10.01e-3, rel=2e-3)  # bound by its operations


def test_counts_agree_with_the_program_layer_plan():
    from msd_tpu_torch.models import build_decoder
    from msd_tpu_torch.ops.fused_train import layer_plan

    plan = layer_plan(build_decoder("deep_sdf_decoder", FLAGSHIP["CodeLength"], FLAGSHIP["NetworkSpecs"]))
    per_point = sum(((plan.prev[i] or 0) + (3 if plan.kinds[i] != "plain" else 0)) * plan.out[i]
                    for i in range(plan.nl))
    assert per_point == counts.point_macs(FLAGSHIP)
