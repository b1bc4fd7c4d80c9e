"""The frozen operation and byte counts against shapes worked by hand."""

import json

import pytest

from portbench.reference import roofline as rl
from portbench.registry import PACKAGE_DIR

E128 = json.loads((PACKAGE_DIR / "configs" / "hm_e128.json").read_text())
WIDE = {**E128, "joint_embedding_size": 1024}  # the arithmetic at E = 1024


def test_refinement_pass_bound_at_the_served_shape():
    # kernel 2 at E = 1024, 128 query rows, L = 2048 over the 106,496
    # padded rows: 128*1024*2 + 106,496*1024*2 bytes in, four (128, 2048)
    # outputs of 4 bytes, two threshold inputs of 4 bytes
    nbytes = 262_144 + 218_103_808 + 4_194_304 + 2_097_152
    assert nbytes == 224_657_408
    got = rl.bin_max_pass_bound_s(128, 1024, 106_496, 2048, 2, True)
    assert got == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert got * 1e3 == pytest.approx(0.0671, abs=5e-5)  # PERF.md's 0.0671
    # the bytes bound it: 27.9 GFLOP take 28.2 us at 989 TFLOP/s
    assert 2 * 128 * 106_496 * 1024 / 989e12 < got


def test_first_pass_bound_has_no_thresholds():
    got = rl.bin_max_pass_bound_s(128, 1024, 106_496, 2048, 2, False)
    assert got * 1e3 == pytest.approx(0.0664, abs=5e-5)  # PERF.md's 0.0664


def test_operations_bound_a_wide_query_block():
    # B = 1024, E = 1024 over 131,072 rows: 275 GFLOP over 989 TFLOP/s
    got = rl.bin_max_pass_bound_s(1024, 1024, 131_072, 2048, 2, False)
    assert got == pytest.approx(2 * 1024 * 131_072 * 1024 / 989e12)


def test_train_step_flops_e128():
    # query 128 -> 256 -> 128, candidate 152 -> 256 -> 128, 3 products a
    # layer of 2*B*in*out; logits 3 * 2 * 8192^2 * 128
    B = 8192
    towers = 3 * 2 * B * (128 * 256 + 256 * 128 + 152 * 256 + 256 * 128)
    logits = 3 * 2 * B * B * 128
    assert rl.train_step_flops(E128, B) == towers + logits
    assert rl.train_step_flops(E128, B) == pytest.approx(58.2e9, rel=2e-3)


def test_train_step_flops_at_joint_1024():
    B = 8192
    towers = 3 * 2 * B * (128 * 256 + 256 * 1024 + 152 * 256 + 256 * 1024)
    logits = 3 * 2 * B * B * 1024
    assert rl.train_step_flops(WIDE, B) == towers + logits
    assert rl.train_ideal_s(WIDE, B) == pytest.approx(441.7e9 / 67e12,
                                                      rel=2e-3)


def test_retrieve_ideal_e128():
    # the query tower 128 -> 256 -> 128 in fp32 (2.0 us), one bf16
    # scoring of the 105,542 real articles (28.0 us)
    B = 1024
    tower = 2 * B * (128 * 256 + 256 * 128) / 67e12
    scoring = 2 * B * 105_542 * 128 / 989e12
    assert rl.retrieve_ideal_s(E128, B) == pytest.approx(tower + scoring)
    assert rl.retrieve_ideal_s(E128, B) * 1e3 == pytest.approx(0.0300,
                                                              abs=5e-4)


def test_retrieve_ideal_at_joint_1024():
    B = 1024
    tower = 2 * B * (128 * 256 + 256 * 1024) / 67e12
    scoring = 2 * B * 105_542 * 1024 / 989e12
    assert rl.retrieve_ideal_s(WIDE, B) == pytest.approx(tower + scoring)
    assert rl.retrieve_ideal_s(WIDE, B) * 1e3 == pytest.approx(0.2326,
                                                              abs=5e-4)
