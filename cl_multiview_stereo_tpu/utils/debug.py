"""Numeric health checks and fail-fast validation.

The reference has no sanitizers and *continues after errors* — often with
inverted success checks (``if (CL_SUCCESS)``, clSLIC.cpp:182) and
fall-through error printers (file_handler.cpp:97-113).  SURVEY.md section 5
prescribes the opposite here: functional purity plus
``checkify`` for NaN/bounds checks and fail-fast on bad stage output.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import numpy as np
from jax.experimental import checkify


def checked(fn: Callable, *, errors=None) -> Callable:
    """Wrap a jittable function with checkify NaN + out-of-bounds checks.

    The wrapper raises ``jax._src.checkify.JaxRuntimeError`` at the first
    NaN/inf or out-of-bounds index produced anywhere inside ``fn`` —
    opt-in debug mode (roughly the equivalent of running the reference's
    host-mirror comparators, SURVEY.md section 4).
    """
    errs = errors if errors is not None else (
        checkify.float_checks | checkify.index_checks
    )
    cfn = checkify.checkify(fn, errors=errs)

    def wrapper(*args, **kw):
        err, out = cfn(*args, **kw)
        err.throw()
        return out

    return wrapper


def validate_stage(name: str, value: Any, *, allow_zero: bool = True) -> None:
    """Fail fast if a stage emitted non-finite values (or all zeros when a
    stage can never legitimately produce them)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(value)[0]:
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        label = f"{name}{jax.tree_util.keystr(path)}"
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"stage '{label}': {bad}/{arr.size} non-finite values"
            )
        if not allow_zero and arr.size and not arr.any():
            raise FloatingPointError(f"stage '{label}': all-zero output")


def validate_artifacts(art) -> None:
    """Fail-fast sweep over a full PipelineArtifacts pytree."""
    for field in art._fields:
        validate_stage(field, getattr(art, field))
