"""The frozen byte counts and peaks against hand-worked values."""

import pytest

from slam_bench import yardstick


def test_peaks():
    assert yardstick.HBM_BYTES_PER_S == 3.35e12 and yardstick.F32_OPS_PER_S == 67e12
    assert yardstick.bound_s(3.35e12) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 67e12) == pytest.approx(1.0)


def test_fast_nms_bytes_kitti():
    # KITTI's pyramid: 8 levels of round(376 / 1.2^l) x round(1241 / 1.2^l):
    # 376x1241 313x1034 261x862 218x718 181x598 151x499 126x416 105x346,
    # 1,444,097 pixels (not the 1808 x 1257 rectangle the program packs them
    # into). A stereo frame: 2 pyramids, each pixel read once and written
    # once, f32.
    assert yardstick.pyramid_pixels(376, 1241, 8, 1.2) == (
        376 * 1241 + 313 * 1034 + 261 * 862 + 218 * 718 + 181 * 598 + 151 * 499 + 126 * 416 + 105 * 346
    ) == 1_444_097
    assert yardstick.fast_nms_bytes(2, 376, 1241, 8, 1.2) == 8 * 2 * 1_444_097 == 23_105_552
    assert yardstick.bound_s(23_105_552) * 1e6 == pytest.approx(6.897, abs=1e-3)


def test_fast_nms_bytes_tum():
    # 480x640 400x533 333x444 278x370 231x309 193x257 161x214 134x179.
    assert yardstick.pyramid_pixels(480, 640, 8, 1.2) == (
        480 * 640 + 400 * 533 + 333 * 444 + 278 * 370 + 231 * 309 + 193 * 257 + 161 * 214 + 134 * 179
    ) == 950_532
    assert yardstick.fast_nms_bytes(1, 480, 640, 8, 1.2) == 7_604_256


def test_segment_sum_bytes():
    # The GBA's U sum at 36,513 live rows: 36 floats and an int64 index a
    # row read, 2048 x 36 floats written (5.84 MB).
    assert yardstick.segment_sum_bytes(36_513, 36, 2048) == 36_513 * 144 + 36_513 * 8 + 2048 * 144 == 5_844_888
    # A point sum of the benchmark's problem: 262,144 rows of 3 into its
    # 65,537 live points (of 262,144 slots).
    assert yardstick.segment_sum_bytes(262_144, 3, 65_537) == 262_144 * (12 + 8) + 65_537 * 12
