"""View-sharded execution of the flagship pipeline.

Strategy (SURVEY.md section 2.3): the view axis is the data-parallel axis —
each device owns ``V / n_view`` views end-to-end.  Stages that only touch
their own view (Lab, SLIC, extent, flatness, rasterization) shard
embarrassingly; the cross-view stages (cost volume, consistency scoring,
fusion vote) read neighbor views' images/superpixel state, which GSPMD
turns into all-gathers over the ``view`` mesh axis (neighbor radius is 1
camera-grid cell, so the gathered footprint is small).
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from cl_multiview_stereo_tpu.config import SystemSettings, DerivedGeometry
from cl_multiview_stereo_tpu.models.mvs_pipeline import XLA_OPTIONS, MVSPipeline


def sharded_pipeline_fn(pipe: MVSPipeline, mesh):
    """Return a jitted fn (V, H, W, 3) uint8 -> (V, H, W) float32 disparity
    with the view axis sharded over ``mesh``'s ``view`` axis."""
    in_s = NamedSharding(mesh, P("view", None, None, None))
    out_s = NamedSharding(mesh, P("view", None, None))

    def fwd(rgb):
        return pipe.run(rgb).disp_full

    return jax.jit(
        fwd, in_shardings=in_s, out_shardings=out_s, compiler_options=XLA_OPTIONS
    )


def run_sharded(pipe: MVSPipeline, rgb: np.ndarray, mesh):
    fn = sharded_pipeline_fn(pipe, mesh)
    return fn(rgb)
