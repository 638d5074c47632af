"""The smoke run's SfM and four-card phases (testing/smoke.py), run here on
the CPU at tiny sizes: the four-card phase on four of the virtual CPU
devices that tests/conftest.py provides."""

import sys

import jax

from cl_multiview_stereo_tpu.testing import smoke

TINY = dict(spixl_size=8, min_disp=4, max_disp=11, kernel_size=8,
            kernel_step=2, no_prop=1)


def test_sfm_phase(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)  # the path must not need it
    res = smoke.sfm_phase(
        str(tmp_path), dict(TINY, array_width=2, array_height=2), 120, 160,
        jax.devices()[1], keypoints=192, ba_iters=8,
    )
    assert res["rms_after"] <= res["rms_before"]
    assert res["cpu_n_matches"] > 100


def test_four_card_phase_on_virtual_devices():
    devs = jax.devices()[:4]
    assert len(devs) == 4
    res = smoke.four_card_phase(
        devs, dict(TINY, array_width=4, array_height=2), 24, 32
    )
    assert res["packed_within"] >= smoke.CMP_MIN_SHARE
    assert res["view_within"] >= smoke.CMP_MIN_SHARE
    assert len(res["peak_bytes_in_use"]) == 4
