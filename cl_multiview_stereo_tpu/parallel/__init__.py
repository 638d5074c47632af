"""Multi-device scaling: meshes, shardings, and the sharded pipeline.

The reference is strictly single-device (``pipeline.cpp:36-38`` picks the
first GPU; the only "communication" is PCIe buffer copies).  Here scaling is
native: a ``jax.sharding.Mesh`` with a ``view`` data-parallel axis (views
are the natural batch, SURVEY.md section 2.3) and an optional ``disp`` axis
for cost-volume hypothesis sharding; cross-view consistency terms ride XLA
collectives inserted by GSPMD, or explicit ``shard_map`` collectives where
we want control.
"""

from cl_multiview_stereo_tpu.parallel.mesh import (
    make_mesh,
    view_sharding,
    replicated,
)
from cl_multiview_stereo_tpu.parallel.distributed import (
    initialize_distributed,
    make_host_view_mesh,
)
from cl_multiview_stereo_tpu.parallel.spatial import (
    disp_sharded_depth_init,
    halo_exchange_rows,
    spatial_plane_sweep,
)
