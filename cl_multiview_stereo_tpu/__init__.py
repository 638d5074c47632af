"""Multi-view stereo + SfM framework in JAX (jit / GSPMD sharding / shard_map).

A from-scratch rebuild of the capabilities of the OpenCL/C++ reference pipeline
clMVDE (kianoosh-j/CL_MultiView_Stereo): SLIC superpixel segmentation,
plane-sweep photo-consistency depth initialization over a camera array,
PatchMatch-style per-superpixel plane propagation/refinement, and cross-view
fusion — re-architected for an accelerator:

* all stage state stays device-resident as dense ``(V, H, W, ...)`` /
  ``(V, Mh, Mw, ...)`` arrays composed under ``jax.jit`` (the reference bounces
  every stage through the host, ``clMVDE/pipeline.cpp``),
* views are a vmapped/sharded axis instead of a host loop
  (``clMVDE/pipeline.cpp:76``, ``photo_consistency.cpp:133``),
* every stage is plain ``jnp``/``lax`` left to XLA: SLIC assignment/update
  are gather-free formulations (parity-selected candidate fields, one-hot
  block reductions); PatchMatch propagation packs its cross-view lookups
  into few wide gathers with all move scoring batched,
* multi-device scaling goes through ``jax.sharding.Mesh`` + ``shard_map``
  collectives (the reference is single-device).

See ``SURVEY.md`` at the repo root for the structural analysis of the
reference that defines behavioral parity.
"""

from cl_multiview_stereo_tpu.config import (
    SystemSettings,
    DerivedGeometry,
    RefinementSchedule,
    build_disp_levels,
    build_view_subsets,
)

__all__ = [
    "SystemSettings",
    "DerivedGeometry",
    "RefinementSchedule",
    "build_disp_levels",
    "build_view_subsets",
]

__version__ = "0.1.0"
