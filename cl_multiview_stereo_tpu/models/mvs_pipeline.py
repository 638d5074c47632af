"""The flagship pipeline: the clMVDE-equivalent multi-view depth engine.

Stage sequence (reference: ``pipeline::exe_pipeline`` + the dormant
``perform_depth_est`` path, ``clMVDE/pipeline.cpp:60-175``):

  RGB -> Lab -> SLIC segmentation -> superpixel extent -> plane-sweep depth
  init -> flatness -> state init -> PatchMatch propagation x no_prop ->
  fusion (plane rasterization [+ optional cross-view vote])

Unlike the reference, which re-uploads every array at each stage
boundary (SURVEY.md section 1), all state here stays device-resident; the
host only touches the input images and the final disparity maps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cl_multiview_stereo_tpu.config import (
    DerivedGeometry,
    RefinementSchedule,
    SlicParams,
    SystemSettings,
    build_disp_levels,
    build_view_subsets,
)
from cl_multiview_stereo_tpu.ops import cost_volume, fusion, refine, slic, superpixel
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab

# Compile options of every whole-pipeline program (``jitted()``, the
# view-sharded program): denormals flush to zero on the GPU as they do on
# XLA:CPU, so the two backends run the same float32 arithmetic mode.
XLA_OPTIONS = {"xla_gpu_ftz": True}


class PipelineArtifacts(NamedTuple):
    """Every stage output, the framework's equivalent of the reference's
    ``results/`` PNG tree (kept as arrays; dump via utils.artifacts)."""

    lab: jax.Array  # (V, H, W, 3)
    labels: jax.Array  # (V, H, W)
    spmap: slic.SuperpixelMap
    extent: jax.Array  # (V, Mh, Mw, 8)
    disp_init: jax.Array  # (V, Mh, Mw)
    flatness: jax.Array  # (V, Mh, Mw, 2)
    state: refine.RefineState
    disp_full: jax.Array  # (V, H, W) fused per-pixel disparity


@dataclasses.dataclass(frozen=True)
class MVSPipeline:
    """Configured pipeline for a fixed geometry (static shapes)."""

    settings: SystemSettings
    geom: DerivedGeometry
    cross_check: bool = False
    # "dense" (shift-plane form, the default) or "gather" (per-sample
    # gathers); both exact
    depth_method: str = "dense"
    # Refinement pair-axis layout: "packed" (single-device default) or "view"
    # (per-ref-view slots — the 7x7 2K rig's memory fix: under GSPMD view
    # sharding every consistency temporary keeps the leading view axis and
    # shards with the mesh; bitwise-equal results, see refine.py)
    pair_layout: str = "packed"
    # Generalized projection: static (ref, view, dvx, dvy) pair list for the
    # refinement consistency term — e.g. from recovered SfM poses
    # (models.sfm_pipeline.pairs_from_poses).  None = the reference's
    # integer camera-grid deltas.
    pair_deltas: tuple | None = None

    @classmethod
    def create(
        cls, img_w: int, img_h: int, settings: SystemSettings | None = None, **kw
    ) -> "MVSPipeline":
        s = settings or SystemSettings()
        return cls(settings=s, geom=DerivedGeometry.create(img_w, img_h, s), **kw)

    # ------------------------------------------------------------------
    def run(
        self, rgb: jax.Array | np.ndarray, _ckpt: dict | None = None
    ) -> PipelineArtifacts:
        """Full pipeline on a (V, H, W, 3) uint8 RGB camera-array batch.

        ``_ckpt``: optional checkpoint dict (``utils.artifacts.load_checkpoint``)
        — stages whose outputs are present are re-entered instead of
        recomputed (``resume()`` is the public wrapper).
        """
        s = self.settings
        geom = self.geom
        sched = RefinementSchedule.create(s)
        # static numpy: the ladder parameterizes compile-time shifts, so it
        # must stay concrete even when run() itself is traced under jit
        disp_levels = build_disp_levels(s)
        view_subset_np, subset_num_np = build_view_subsets(s)
        view_subset = jnp.asarray(view_subset_np)
        subset_num = jnp.asarray(subset_num_np)
        ck = _ckpt or {}

        lab = rgb_to_lab(jnp.asarray(rgb))
        if "labels" in ck and "center" in ck:
            labels = jnp.asarray(ck["labels"])
            spmap = slic.SuperpixelMap(
                center=jnp.asarray(ck["center"]),
                color=jnp.asarray(ck["color"]),
                count=jnp.asarray(
                    ck.get("count", np.zeros(ck["center"].shape[:3], np.float32))
                ),
                disp=jnp.zeros(ck["center"].shape[:3], jnp.float32),
            )
        else:
            labels, spmap = slic.segment(lab, geom, SlicParams.create(s))
        extent = superpixel.superpixel_extent(labels, spmap.center, geom)
        if "disp_init" in ck:
            disp_init = jnp.asarray(ck["disp_init"])
        else:
            disp_init = cost_volume.initial_depth_estimation(
                lab,
                spmap.center,
                extent,
                disp_levels,
                view_subset,
                subset_num,
                s.array_width,
                s.bl_ratio,
                method=self.depth_method,
                neib_hor=s.neib_hor,
                neib_ver=s.neib_ver,
                # the wide-row dense tables REPLICATE under GSPMD view
                # sharding (terabytes per device at the 7x7 2K rig) — the
                # sharded memory-constrained mode keeps the per-hypothesis
                # form
                dense_wide_rows=(self.pair_layout != "view"),
            )
        flatness = refine.compute_flatness(spmap.color, sched.gamma_eff)
        # SLIC label-locality bound for the gather-free per-pixel lookups:
        # assignment confines labels to the 3x3 cell window (radius 1); each
        # suppress_local_labels pass (x2 when enforce_connectivity) can pull
        # a label from one cell further (fusion.select_cell_lookup)
        label_radius = 1 + (2 if s.enforce_connectivity else 0)
        ctx = refine.make_context(
            spmap.center,
            spmap.color,
            disp_init,
            labels,
            extent,
            flatness,
            view_subset,
            s.array_width,
            spixl_size=s.spixl_size,
            label_radius=label_radius,
        )
        # static pair list from the concrete numpy tables (the context's
        # arrays are tracers when run() itself is being jitted); recovered
        # SfM poses slot in here as generalized float deltas
        if self.pair_deltas is not None:
            pairs = self.pair_deltas
        else:
            pairs = refine.pairs_from_subsets(view_subset_np, s.array_width)
        if "state_d" in ck:
            state = refine.RefineState(
                d=jnp.asarray(ck["state_d"]),
                sm=jnp.asarray(ck["state_sm"]),
                cs=jnp.asarray(ck["state_cs"]),
                n=jnp.asarray(ck["state_n"]),
            )
        else:
            state = refine.refine(
                ctx, sched, pairs=pairs,
                spixl_size=s.spixl_size, label_radius=label_radius,
                pair_layout=self.pair_layout,
            )
        disp_full = fusion.fuse_views(
            labels,
            spmap.center,
            state.d,
            state.n,
            s.array_width,
            s.bl_ratio,
            sched.fuse_eff,
            cross_check=self.cross_check,
            spixl_size=s.spixl_size,
            label_radius=label_radius,
        )
        return PipelineArtifacts(
            lab=lab,
            labels=labels,
            spmap=spmap,
            extent=extent,
            disp_init=disp_init,
            flatness=flatness,
            state=state,
            disp_full=disp_full,
        )

    def resume(
        self, rgb: jax.Array | np.ndarray, checkpoint_path: str
    ) -> PipelineArtifacts:
        """Re-enter the pipeline from a saved checkpoint
        (``utils.artifacts.save_checkpoint`` / CLI ``--checkpoint``): the
        deepest stage whose outputs the npz holds is skipped, everything
        after it recomputes.  With a full post-refinement checkpoint only
        fusion runs; with a post-SLIC one (labels/center/color) depth init
        onward runs.  Matches the straight-through ``run()`` bitwise for
        the skipped prefix (tests/test_checkpoint_resume.py).
        """
        from cl_multiview_stereo_tpu.utils.artifacts import load_checkpoint

        ck = load_checkpoint(checkpoint_path)
        self._validate_checkpoint(ck, checkpoint_path)
        return self.run(rgb, _ckpt=ck)

    def _validate_checkpoint(self, ck: dict, path: str) -> None:
        """Fail fast on partial key groups or arrays from a different
        scene/config (advisor r4): a stage re-enters only when its WHOLE
        output group is present, and every present array must match this
        pipeline's static geometry."""
        g = self.geom
        v, mh, mw, h, w = g.view_num, g.map_h, g.map_w, g.img_h, g.img_w
        groups = {
            "SLIC": (("labels", (v, h, w)), ("center", (v, mh, mw, 2)),
                     ("color", (v, mh, mw, 3))),
            "depth-init": (("disp_init", (v, mh, mw)),),
            "refinement": (("state_d", (v, mh, mw)), ("state_sm", (v, mh, mw)),
                           ("state_cs", (v, mh, mw)), ("state_n", (v, mh, mw, 3))),
        }
        for stage, keys in groups.items():
            present = [k for k, _ in keys if k in ck]
            if present and len(present) < len(keys):
                missing = [k for k, _ in keys if k not in ck]
                raise ValueError(
                    f"checkpoint '{path}': partial {stage} group — has "
                    f"{present}, missing {missing}; cannot resume this stage"
                )
            for k, shape in keys:
                if k in ck and tuple(np.asarray(ck[k]).shape) != shape:
                    raise ValueError(
                        f"checkpoint '{path}': '{k}' has shape "
                        f"{tuple(np.asarray(ck[k]).shape)} but this pipeline "
                        f"(views={v}, {w}x{h}, map {mw}x{mh}) expects {shape} "
                        f"— wrong scene or settings?"
                    )

    def jitted(self):
        """One-jit end-to-end forward: (V, H, W, 3) uint8 -> PipelineArtifacts.

        ``run()`` dispatches each stage's jit separately (convenient for
        debugging/artifact inspection); this fuses the whole pipeline into a
        single compiled program — one host->device dispatch per scene and
        full cross-stage fusion, the device-resident design of SURVEY.md
        section 7.1.
        """
        return jax.jit(self.run, compiler_options=XLA_OPTIONS)

    def run_from_list(self, list_path: str) -> PipelineArtifacts:
        from cl_multiview_stereo_tpu.io.images import load_image_array

        rgb = load_image_array(list_path, self.settings.view_num)
        if rgb.shape[2] != self.geom.img_w or rgb.shape[1] != self.geom.img_h:
            raise ValueError(
                f"images are {rgb.shape[2]}x{rgb.shape[1]}, pipeline built for "
                f"{self.geom.img_w}x{self.geom.img_h}"
            )
        return self.run(rgb)
