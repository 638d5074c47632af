"""The on-card smoke run's checks and phases (testing/smoke.py,
chip_smoke.py), run here on the CPU at tiny sizes.

The phases take their devices as arguments, so the GPU-vs-CPU comparison
runs here between two virtual CPU devices: that exercises the comparison,
not the GPU.  The run on the card is ``python chip_smoke.py``.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest

from cl_multiview_stereo_tpu.config import SystemSettings
from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline
from cl_multiview_stereo_tpu.testing import smoke
from cl_multiview_stereo_tpu.utils import compile_cache

# tiny geometry: 3x3 views, 8 hypotheses, 2 propagation iterations
TINY = dict(spixl_size=8, min_disp=4, max_disp=11, kernel_size=8,
            kernel_step=2, no_prop=2)


# ------------------------------------------------------------ device
def test_parse_nvidia_smi_one_and_four_cards():
    assert smoke.parse_nvidia_smi("NVIDIA H100 80GB HBM3, 700.00 W\n") == [
        ("NVIDIA H100 80GB HBM3", "700.00 W")
    ]
    four = "\n".join(["NVIDIA H100 80GB HBM3, 500.00 W"] * 4)
    assert len(smoke.parse_nvidia_smi(four)) == 4


@pytest.mark.parametrize(
    "text", ["", "NVIDIA H100 80GB HBM3", "NVIDIA H100, [N/A]", ", 700.00 W"]
)
def test_parse_nvidia_smi_refuses_unreadable(text):
    with pytest.raises(smoke.SmokeFailure):
        smoke.parse_nvidia_smi(text)


def test_query_cards_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))  # no nvidia-smi anywhere
    with pytest.raises(smoke.SmokeFailure, match="nvidia-smi"):
        smoke.query_cards()


def test_require_gpu_refuses_cpu():
    with pytest.raises(smoke.SmokeFailure, match="not on a GPU"):
        smoke.require_gpu(jax.devices())
    with pytest.raises(smoke.SmokeFailure, match="no device"):
        smoke.require_gpu([])

    class FakeGpu:
        platform = "gpu"

    smoke.require_gpu([FakeGpu()])


def test_chip_smoke_refuses_cpu_and_prints_no_result(capsys):
    import chip_smoke

    before = jax.config.jax_compilation_cache_dir
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert "not on a GPU" in err
    assert '"ok"' not in out
    # refused before any phase, and before touching the compile cache
    assert jax.config.jax_compilation_cache_dir == before


# ------------------------------------------------------------ compile cache
def test_compile_cache_honours_env(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert compile_cache.configure_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.configure_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert compile_cache.configure_compile_cache() == got  # same every call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ------------------------------------------------------------ helpers
def test_share_helpers_on_constructed_arrays():
    a = np.zeros((4, 5), np.float32)
    b = a.copy()
    b[0, :2] = 5e-4  # within 1e-3
    b[1, 0] = 2e-3  # outside
    b[2, 0] = np.nan  # never agrees
    assert smoke.within_share(a, b) == pytest.approx(18 / 20)
    assert smoke.equal_share(a, b) == pytest.approx(16 / 20)
    with pytest.raises(smoke.SmokeFailure, match="shapes"):
        smoke.within_share(a, b[:3])


def test_truth_share_leaves_out_the_margin():
    gt = np.full((10, 12), 7.0, np.float32)
    disp = gt.copy()
    disp[:2] = 0.0  # border rows, inside the margin
    disp[4, 4] = 9.0  # interior miss
    share = smoke.truth_share(disp, gt, margin=2, tol=1.5)
    assert share == pytest.approx(1 - 1 / (6 * 8))


def test_write_scene_roundtrips_through_the_list(tmp_path):
    from cl_multiview_stereo_tpu.io.images import load_image_array

    s = SystemSettings().replace(**TINY)
    rgb, gt = smoke.scene(s, 24, 32, seed=1, disp_bg=5.0, disp_fg=9.0)
    list_path = smoke.write_scene(str(tmp_path), rgb)
    np.testing.assert_array_equal(load_image_array(list_path, s.view_num), rgb)
    assert gt.shape == (24, 32)
    assert smoke.settings_args({"no_prop": 2}) == ["--set", "no_prop=2"]


# ------------------------------------------------------------ phases
def test_cli_run_phase(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)  # the path must not need it
    res = smoke.cli_run_phase(
        str(tmp_path), TINY, 64, 96, disp_bg=5.0, disp_fg=9.0
    )
    assert res["pngs"] == 9 and res["ply"]
    assert res["truth_within_1.5"] >= smoke.TRUTH_MIN_SHARE
    assert res["truth_within_1"] <= res["truth_within_1.5"]
    json.dumps(res)  # printable as the smoke run's phase line


def test_steady_phase():
    s = SystemSettings().replace(**TINY)
    scenes = [smoke.scene(s, 48, 64, seed, 5.0, 9.0)[0] for seed in range(2)]
    res = smoke.steady_phase(MVSPipeline.create(64, 48, s), scenes, jax.devices()[0])
    assert len(res["scene_s"]) == 2 and res["first_call_s"] > 0
    assert res["mp_per_s"] > 0


def test_backend_compare_phase_and_its_bound():
    s = SystemSettings().replace(**TINY)
    rgb, _ = smoke.scene(s, 48, 64, 0, 5.0, 9.0)
    devs = jax.devices()
    res = smoke.backend_compare_phase(
        MVSPipeline.create(64, 48, s), rgb, devs[0], devs[1]
    )
    assert res["disp_init_equal"] == 1.0
    assert res["disp_full_within"] == 1.0
