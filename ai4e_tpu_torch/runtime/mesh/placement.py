"""Device placement for the mesh serving plane — counterpart of
``ai4e_tpu/runtime/mesh/placement.py``, thin layers over
``parallel/sharding.py``:

- **layout -> mesh**: the declarative ``MeshLayout`` becomes the named
  ``DeviceMesh`` over the process group's ranks (``make_mesh``'s
  dp/fsdp/ep/sp/tp order, tp innermost), after checking that the layout
  covers exactly the ranks present;
- **batch-axis placement**: the spec that puts a request batch's leading
  dimension on the data axes and replicates the rest;
- **partition rules**: resolve a regex rule set against a flax-shaped
  param tree (first match wins, complete by construction — see
  ``spec_for_param``) so a registration error names every unmapped param
  at once;
- ``fetch_to_host``: outputs as host numpy arrays.
"""

from __future__ import annotations

import numpy as np

from ...parallel.sharding import (BATCH_AXES, MeshSpec, make_mesh,
                                  process_count, spec_for_param)
from .spec import MeshLayout


def mesh_for_layout(layout: MeshLayout, device_type: str | None = None):
    """The named device mesh for a validated serving layout; raises
    ``MeshSpecError`` before touching the process group when the layout
    does not cover exactly the ranks present. The one-rank layout on one
    process is ``None``: no process group, every axis of size 1."""
    ranks = process_count()
    layout.validate(ranks, ranks)
    if ranks == 1:
        return None
    return make_mesh(MeshSpec(dp=layout.dp, tp=layout.tp, sp=layout.sp),
                     device_type=device_type)


def batch_axis_spec(ndim: int, batch_axis: int = 0) -> tuple:
    """Spec placing dimension ``batch_axis`` of a rank-``ndim`` array on
    the data axes, everything else replicated."""
    if not 0 <= batch_axis < ndim:
        raise ValueError(f"batch_axis {batch_axis} out of range for "
                         f"rank-{ndim} input")
    axes: list = [None] * ndim
    axes[batch_axis] = BATCH_AXES
    return tuple(axes)


def batch_placement(mesh, ndim: int, batch_axis: int = 0) -> tuple:
    """The input/output spec for request batches on ``mesh``."""
    return batch_axis_spec(ndim, batch_axis)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key in tree:
            yield from _leaves(tree[key], path + (key,))
    else:
        yield path, tree


def match_partition_rules(rules, params) -> dict[str, tuple]:
    """Resolve a regex rule set against a param tree WITHOUT placing it:
    ``{joined/param/path: spec}`` for introspection and registration-time
    validation. Raises ``ValueError`` naming every unmatched non-scalar
    param at once."""
    resolved: dict[str, tuple] = {}
    missing: list[str] = []
    for path, leaf in _leaves(params):
        joined = "/".join(str(p) for p in path)
        try:
            resolved[joined] = spec_for_param(path, np.asarray(leaf), rules)
        except ValueError:
            missing.append(joined)
    if missing:
        raise ValueError(
            f"partition rules leave {len(missing)} param(s) unmapped: "
            f"{', '.join(missing)} (add rules or a ('.*', ()) catch-all)")
    return resolved


def fetch_to_host(out):
    """Outputs (a tensor or a dict of tensors) as numpy arrays."""
    if isinstance(out, dict):
        return {k: fetch_to_host(v) for k, v in out.items()}
    return out.detach().cpu().numpy() if hasattr(out, "detach") else out
