"""Worker process for the simulated 2-host distributed test.

Spawned by ``tests/test_multihost.py`` as ``python multihost_worker.py
<coordinator_addr> <num_processes> <process_id>``.  Each process exposes 4
virtual CPU devices, joins the ``jax.distributed`` cluster (DCN =
localhost), builds the ``(host, view)`` mesh and runs the view-sharded
flagship pipeline on a global batch of 8 views — the only way to exercise
the multi-controller code path (``parallel/distributed.py``) without
several hosts.

Exactness check: every process also runs the unsharded pipeline on one of
its own local devices (non-collective) and asserts its addressable output
shards match that reference slice — so host-axis sharding is validated
without any cross-process gather.
"""

from __future__ import annotations

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(addr: str, nproc: int, pid: int) -> None:
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cl_multiview_stereo_tpu.config import SystemSettings
    from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu.parallel.distributed import (
        initialize_distributed,
        make_host_view_mesh,
    )

    initialize_distributed(addr, nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    devs = jax.devices()
    per_host = 4
    assert len(devs) == nproc * per_host, devs

    mesh = make_host_view_mesh()
    assert mesh.shape == {"host": nproc, "view": per_host}

    s = SystemSettings(
        array_width=4,
        array_height=2,
        spixl_size=8,
        min_disp=2,
        max_disp=5,
        inc=1,
        bl_ratio=1.0,
        kernel_size=8,
        kernel_step=2,
        no_prop=1,
    )
    pipe = MVSPipeline.create(32, 24, s)
    rgb = np.random.default_rng(0).integers(
        0, 256, size=(s.view_num, 24, 32, 3), dtype=np.uint8
    )

    # views sharded over (host x view): process p owns views [4p, 4p+4)
    vspec = P(("host", "view"))
    in_s = NamedSharding(mesh, P(("host", "view"), None, None, None))
    out_s = NamedSharding(mesh, P(("host", "view"), None, None))
    local = rgb[pid * per_host : (pid + 1) * per_host]
    garr = jax.make_array_from_process_local_data(in_s, local, rgb.shape)

    fn = jax.jit(
        lambda x: pipe.run(x).disp_full, in_shardings=in_s, out_shardings=out_s
    )
    disp = fn(garr)
    disp.block_until_ready()
    assert disp.shape == (s.view_num, 24, 32)

    # local (non-collective) unsharded reference on this process's device 0
    local_dev = jax.local_devices()[0]
    ref = np.asarray(
        jax.device_get(pipe.jitted()(jax.device_put(rgb, local_dev)).disp_full)
    )
    assert np.isfinite(ref).all()
    for shard in disp.addressable_shards:
        got = np.asarray(jax.device_get(shard.data))
        want = ref[shard.index]
        assert np.allclose(got, want, rtol=1e-5, atol=1e-5), (
            f"process {pid} shard {shard.index} diverged: "
            f"max|diff|={np.max(np.abs(got - want))}"
        )
    del vspec
    print(f"MULTIHOST_WORKER_OK pid={pid}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
