"""Native scene prefetcher: background decode pipeline vs direct loads."""

import numpy as np
import pytest

from cl_multiview_stereo_tpu.io.png import write_png


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    rng = np.random.default_rng(0)
    scenes = []
    arrays = []
    for s in range(3):
        paths = []
        views = []
        for v in range(2):
            arr = rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8)
            p = root / f"s{s}_v{v}.png"
            write_png(str(p), arr)
            paths.append(str(p))
            views.append(arr)
        scenes.append(paths)
        arrays.append(np.stack(views))
    return scenes, arrays


def test_prefetcher_matches_direct_loads(scene_files):
    from cl_multiview_stereo_tpu.io.prefetcher import ScenePrefetcher

    scenes, arrays = scene_files
    with ScenePrefetcher(scenes, 24, 32, depth=2) as pf:
        got = list(pf)
    assert [i for i, _ in got] == [0, 1, 2]
    for (i, arr), want in zip(got, arrays):
        np.testing.assert_array_equal(arr, want)


def test_prefetcher_codec_fallback(scene_files, monkeypatch):
    """Without the native library the prefetcher decodes synchronously
    through the numpy PNG codec and yields the same arrays."""
    from cl_multiview_stereo_tpu.io import prefetcher

    monkeypatch.setattr(prefetcher, "_lib", lambda: None)
    scenes, arrays = scene_files
    with prefetcher.ScenePrefetcher(scenes, 24, 32) as pf:
        assert pf._handle is None
        got = list(pf)
    assert [i for i, _ in got] == [0, 1, 2]
    for (_, arr), want in zip(got, arrays):
        np.testing.assert_array_equal(arr, want)


def test_prefetcher_native_backend_used(scene_files):
    from cl_multiview_stereo_tpu.io.native_loader import native_available
    from cl_multiview_stereo_tpu.io.prefetcher import ScenePrefetcher

    if not native_available():
        pytest.skip("native toolchain unavailable")
    scenes, _ = scene_files
    pf = ScenePrefetcher(scenes, 24, 32)
    assert pf._handle is not None
    pf.close()


def test_prefetcher_decode_failure(scene_files, tmp_path):
    from cl_multiview_stereo_tpu.io.native_loader import native_available
    from cl_multiview_stereo_tpu.io.prefetcher import ScenePrefetcher

    if not native_available():
        pytest.skip("native toolchain unavailable")
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    with ScenePrefetcher([[str(bad), str(bad)]], 24, 32) as pf:
        with pytest.raises(IOError):
            list(pf)
