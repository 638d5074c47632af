"""Build the native loader shared library (g++, libpng/libjpeg/zlib).

The library is never committed: it is compiled from ``loader.cc`` at first
use.  Its file name carries a digest of the source, so an edited source
builds a new library and a stale one is never loaded.  No pip/pybind
involved — plain C ABI consumed via ctypes.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "loader.cc")


def lib_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(_DIR, f"libmvsloader.{digest}.so")


def ensure_built() -> str:
    """Compile the library unless this source's build exists; returns its
    path.  Raises ``RuntimeError`` with the compiler's output on failure."""
    lib = lib_path()
    if os.path.exists(lib):
        return lib
    # build beside the target, then rename: concurrent builders (test
    # workers) never load a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
    os.close(fd)
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17", SRC,
        "-o", tmp, "-lpng", "-ljpeg", "-lz", "-lpthread",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run g++: {e}") from None
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()}")
    os.replace(tmp, lib)
    return lib
