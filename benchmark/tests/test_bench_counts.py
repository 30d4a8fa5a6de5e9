"""The roofline counts at the flagship's shapes (33 levels of 721 x 1440 in
float32, SETTLS-4, cubic taps)."""
import numpy as np
import pytest

from benchmark import harness, peaks

FLAGSHIP = {"grid": {"ny": 721, "nx": 1440}, "levels": 33,
            "dtype": "float32", "settls_order": 4, "interp_order": 3}


def test_prefilter_bytes():
    m = harness.reader("prefilter_roofline_pct")
    b = m.bytes_needed(33, 721, 1440, 4)
    assert b == 548_190_720
    assert peaks.bound_s(nbytes=b) * 1e3 == pytest.approx(0.16364, abs=1e-5)


def test_ftle_bytes():
    b = harness.reader("ftle_roofline_pct").bytes_needed(721, 1440, 4)
    assert b == 12_458_880
    assert peaks.bound_s(nbytes=b) * 1e6 == pytest.approx(3.719, abs=1e-3)


def test_settls_count():
    m = harness.reader("settls_loop_roofline_pct")
    assert m.ops_per_parcel_step(4) == 786
    assert m.ops_per_parcel_step(0) == 106
    ops = m.ops_needed(33, 721, 1440, 4)
    assert ops == 721 * 1440 * 32 * 786 == 26_113_812_480
    nbytes = m.bytes_needed(33, 721, 1440, 4, 3)
    assert nbytes == 2 * 33 * 721 * 1440 * 4 + 2 * 33 * 6 * 1440 * 4 \
        + 4 * 721 * 1440 * 4
    # the operations bound it: 0.3898 ms against 0.0875 ms of bytes
    assert m.bound(FLAGSHIP) * 1e3 == pytest.approx(0.38976, abs=1e-5)
    assert nbytes / peaks.HBM_BYTES_PER_S < m.bound(FLAGSHIP)


def test_shares_read_the_bound_over_device_time():
    assert peaks.share_pct(1e-3, 4e-3) == 25.0
    assert np.isclose(peaks.bound_s(flops=67e9, nbytes=1.0), 1e-3)
