"""Model families: end-to-end depth-estimation pipelines built from the ops.

* ``plane_sweep`` — dense per-pixel plane-sweep stereo (the
  ``initial_depth_estimation_v2`` math without superpixels), the minimum
  end-to-end slice.
* ``mvs_pipeline`` — the flagship clMVDE-equivalent pipeline:
  SLIC -> superpixel depth init -> PatchMatch refinement -> fusion.
* ``sfm`` — north-star extension: features, matching, poses, distributed
  bundle adjustment.
"""
