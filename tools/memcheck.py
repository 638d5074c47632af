"""AOT memory analysis of the single-jit flagship pipeline at bench shapes.

Usage: python tools/memcheck.py [H W] [key=val ...] [--sharded N]

Compiles ``MVSPipeline.jitted()`` without running it and prints the
compiler's memory analysis — the guard against a layout change that
balloons HLO temporaries past device memory.  Runs on whatever backend is
active (the GPU, or the CPU under JAX_PLATFORMS=cpu).  ``key=val`` pairs
override SystemSettings fields (e.g. the 7x7 2K rig with 256 hypotheses:
``2048 2048 array_width=7 array_height=7 min_disp=0 max_disp=255
inc=1``); ``--sharded N`` compiles the GSPMD view-sharded pipeline over an
N-device mesh instead.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    args = [a for a in sys.argv[1:]]
    sharded = 0
    if "--sharded" in args:
        i = args.index("--sharded")
        sharded = int(args[i + 1])
        del args[i : i + 2]
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={sharded}"
        ).strip()
    pair_layout = "packed"
    if "--pair-layout" in args:
        i = args.index("--pair-layout")
        pair_layout = args[i + 1]
        del args[i : i + 2]
    pos = [a for a in args if "=" not in a]
    kv = dict(a.split("=", 1) for a in args if "=" in a)
    h = int(pos[0]) if pos else 1080
    w = int(pos[1]) if len(pos) > 1 else 1920

    import jax

    if sharded:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cl_multiview_stereo_tpu.config import SystemSettings
    from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline

    s = SystemSettings()
    if kv:
        s = s.replace(**{k: json.loads(v) for k, v in kv.items()})
    pipe = MVSPipeline.create(w, h, s, pair_layout=pair_layout)
    if sharded:
        from cl_multiview_stereo_tpu.parallel.mesh import make_mesh
        from cl_multiview_stereo_tpu.parallel.sharded_pipeline import (
            sharded_pipeline_fn,
        )

        mesh = make_mesh(n_view=sharded, n_disp=1, devices=jax.devices()[:sharded])
        fn = sharded_pipeline_fn(pipe, mesh)
        rgb = jax.ShapeDtypeStruct((s.view_num, h, w, 3), jnp.uint8)
        t0 = time.time()
        compiled = fn.lower(rgb).compile() if hasattr(fn, "lower") else None
        if compiled is None:
            compiled = jax.jit(fn).lower(rgb).compile()
        ma = compiled.memory_analysis()
        gb = 1024.0**3
        print(f"sharded={sharded} compile_s={time.time()-t0:.1f}")
        print(f"temp_gb={ma.temp_size_in_bytes / gb:.3f} (per device)")
        print(f"arg_gb={ma.argument_size_in_bytes / gb:.3f}")
        return
    rgb = jax.ShapeDtypeStruct((s.view_num, h, w, 3), jnp.uint8)

    t0 = time.time()
    compiled = jax.jit(pipe.run).lower(rgb).compile()
    dt = time.time() - t0
    ma = compiled.memory_analysis()
    gb = 1024.0**3
    print(f"backend={jax.default_backend()} compile_s={dt:.1f}")
    print(f"temp_gb={ma.temp_size_in_bytes / gb:.3f}")
    print(f"arg_gb={ma.argument_size_in_bytes / gb:.3f}")
    print(f"out_gb={ma.output_size_in_bytes / gb:.3f}")
    print(f"code_mb={ma.generated_code_size_in_bytes / 1024.0**2:.1f}")


if __name__ == "__main__":
    main()
