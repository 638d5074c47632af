import numpy as np
import pytest

from cl_multiview_stereo_tpu.io.images import load_image_array
from cl_multiview_stereo_tpu.io.native_loader import (
    load_image_array_native,
    native_available,
)


@pytest.fixture()
def scene_list(tmp_path):
    from cl_multiview_stereo_tpu.io.png import write_png

    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        img = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
        p = tmp_path / f"v{i}.png"
        write_png(str(p), img)
        paths.append(str(p))
    lst = tmp_path / "data.txt"
    lst.write_text("\n".join(paths))
    return str(lst)


def test_native_matches_pil(scene_list):
    if not native_available():
        pytest.skip("native toolchain unavailable")
    a = load_image_array(scene_list)
    b = load_image_array_native(scene_list)
    np.testing.assert_array_equal(a, b)


def test_native_error_on_missing(tmp_path):
    if not native_available():
        pytest.skip("native toolchain unavailable")
    lst = tmp_path / "data.txt"
    lst.write_text("nope.png\n")
    with pytest.raises(IOError):
        load_image_array_native(str(lst))


def test_build_failure_reported_once_then_codec(scene_list, monkeypatch, capsys):
    """A library that cannot be built is reported once; loading then goes
    through the numpy PNG codec with the same result."""
    from cl_multiview_stereo_tpu.io import native_loader
    from cl_multiview_stereo_tpu.native import build

    def fail():
        raise RuntimeError("g++ failed (1): no compiler")

    monkeypatch.setattr(build, "ensure_built", fail)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_failed", False)
    a = load_image_array_native(scene_list)
    b = load_image_array_native(scene_list)
    assert not native_available()
    err = capsys.readouterr().err
    assert err.count("native image loader unavailable") == 1
    assert "no compiler" in err
    np.testing.assert_array_equal(a, load_image_array(scene_list))
    np.testing.assert_array_equal(a, b)


def test_build_named_by_source_digest():
    from cl_multiview_stereo_tpu.native import build

    path = build.lib_path()
    assert path.startswith(build._DIR) and path.endswith(".so")
    assert path == build.lib_path()  # stable for an unchanged source
