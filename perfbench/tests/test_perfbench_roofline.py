"""The frozen bounds against hand counts (H100 SXM: 67 TFLOP/s f32,
3.35 TB/s)."""
from __future__ import annotations

import pytest

from perfbench import roofline


def test_policy_mlp_bound_at_q2560():
    # 2 (8*64 + 64*32 + 32) = 5,184 FLOP a row, 2,560 live rows
    flops = 5184 * 2560
    # x (2560 x 8), mask and output (2560 each), weights 8*64 + 64 + 64*32
    # + 32 + 32 + 1 = 2,689: 28,289 words of 4 bytes
    nbytes = 4 * 28289
    assert flops / 67e12 > nbytes / 3.35e12          # operations bound it
    assert roofline.policy_mlp_s(2560, 2560) == pytest.approx(
        13271040 / 67e12, rel=1e-12)
    # the head launch: 256 rows; masked rows cost bytes, not operations
    assert roofline.policy_mlp_s(256, 40) == pytest.approx(
        max(5184 * 40 / 67e12, 4 * (256 * 10 + 2689) / 3.35e12), rel=1e-12)


def test_predict_mlp_bound_at_b1024():
    # 2 (21*24 + 24*12 + 12*2) = 1,632 FLOP a row
    flops = 1632 * 1024
    # x (1024 x 21), output (1024 x 2), weights 504 + 24 + 288 + 12 + 24
    # + 2 = 854: 24,406 words
    nbytes = 4 * 24406
    assert nbytes / 3.35e12 > flops / 67e12          # bytes bound it
    assert roofline.predict_mlp_s(1024) == pytest.approx(97624 / 3.35e12,
                                                         rel=1e-12)
