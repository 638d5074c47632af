"""Golden-output parity vs the reference's shipped result PNGs.

These run the FULL pipeline at 1080p (9-view Beer-Garden for both the
depth-init and fusion anchors — round-5 forensics showed initD_dev0..8
are a Beer-Garden run) — tens of minutes on the CPU — so they are
slow-marked AND gated behind ``GOLDEN_PARITY=1``, and they need the
reference checkout.  The thresholds sit just under the miss-rates an
earlier accelerator run measured, so regressions surface.

Caveat on absolute levels: the goldens are the only artifacts the reference
ever produced, but they come from unlabeled experiment variants
(``changes notes.txt``) — exact agreement is not expected; large-majority
within-one-quantum agreement is.
"""

from __future__ import annotations

import os
import sys

import pytest

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        not os.environ.get("GOLDEN_PARITY"),
        reason="full-res golden parity: set GOLDEN_PARITY=1 (needs the reference checkout)",
    ),
]

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


def test_depth_init_parity_vs_initD_dev():
    # measured on the chip (round 5): agree_tol 0.470, mean 22.5 quanta —
    # after the scene forensics fix (initD_dev0..8 are a BEER-GARDEN run
    # at the committed config, not the Bar scene; tools/golden_sweep.py).
    # Round 3's 0.094 compared against the wrong scene.
    import golden_parity as gp

    stats = gp.run_init_parity(per_view=False)["all"]
    print("init parity:", stats)
    assert stats["agree_tol"] > 0.44, stats
    assert stats["mean_abs_quanta"] < 26.0, stats


def test_fusion_parity_vs_fus4():
    # measured on the chip (round 3): agree_tol 0.207, mean 29.0 quanta.
    # Side-by-side, the golden fus4 maps carry heavy salt-and-pepper plane
    # speckle in the low-texture background that our (mirror-pinned)
    # refinement does not reproduce — the agreement ceiling is set by the
    # goldens' unknown experiment config, so this anchors drift
    import golden_parity as gp

    stats = gp.run_fusion_parity(per_view=False)["all"]
    print("fusion parity:", stats)
    assert stats["agree_tol"] > 0.18, stats
    assert stats["mean_abs_quanta"] < 33.0, stats
