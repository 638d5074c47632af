"""Compute ops: vectorized ``jnp``/``lax`` implementations left to XLA.

Each op is the source of truth for its behavior and is checked against the
pure-numpy scalar mirrors in ``cl_multiview_stereo_tpu.testing.mirror``.
"""
