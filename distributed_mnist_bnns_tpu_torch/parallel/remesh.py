"""Re-placing training state across data-parallel worlds (the JAX
package's ``parallel/remesh.py``, the state half of elastic
membership).

A checkpoint written at world ``W_old`` holds the 1-bit exchange's rows
laid out for that world (``train.optim.SignCompress`` and
``SignCompressFsdp``, saved in JAX's ``(world, ...)`` layout). A run
rebuilt at ``W_new`` with ``TrainConfig.elastic`` re-places them before
it loads them (``Trainer.try_resume`` and ``restore``):

* per-worker rows (``ef_residual``: one residual a worker over the
  padded flat gradient) fold by the groupwise mean of adjacent rows on
  a shrink, and are copied to their successors on a regrow
  (``fold_worker_rows``): the exchange combines workers by their mean,
  so the mean of the residuals is kept;
* per-segment-owner rows (``ef_residual2``, and the base optimizer's
  moments of the compressed FSDP exchange, row ``j`` covering the
  positions ``[j*seg, (j+1)*seg)`` of the flat parameters) are one
  vector by position, re-cut at the new segment bounds
  (``refold_segment_rows``): every parameter keeps its own moments.

A change of width (the plans' ``padded`` and ``seg`` differ across
worlds) copies the common prefix; positions from ``n_params`` on are
zero by the exchange's invariant. Everything here is host-side numpy on
the checkpoint's tree (flax's state-dict layout, nested dicts), kept
apart from the JAX package: the port imports none of it.

The elastic supervisor (``run_elastic``, ``cli train --elastic``) and
the chaos membership faults are not ported yet: they report through
``obs/`` telemetry and come with it (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Tuple

import numpy as np
import torch.distributed as dist

from ..ops.comm_compress import CommPlan, make_plan

log = logging.getLogger(__name__)

_EF_KEYS = {"ef_residual", "ef_residual2"}


def mesh_topology(group=None) -> Tuple[int, Dict[str, int]]:
    """``(data-parallel world, {axis: size})`` of the process group
    (``(1, {})`` outside one), the fields a checkpoint's meta records
    (the JAX ``mesh_topology`` of a mesh, None giving ``(1, {})``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, {}
    world = dist.get_world_size(group)
    return world, {"data": world}


def fold_worker_rows(rows: np.ndarray, new_world: int,
                     new_width: int) -> np.ndarray:
    """Per-worker rows ``(old_world, old_width)`` -> ``(new_world,
    new_width)``: a shrink (``old_world % new_world == 0``) takes the
    mean of each group of adjacent rows, new worker ``j`` absorbing old
    workers ``[g*j, g*(j+1))`` as the batch's rows are re-sharded; a
    regrow copies each row to its ``g`` successors. Any other pair of
    worlds raises."""
    rows = np.asarray(rows)
    if rows.ndim != 2:
        raise ValueError(f"worker rows must be 2-D, got {rows.shape}")
    old_world, old_width = rows.shape
    if old_world == new_world:
        folded = rows
    elif old_world % new_world == 0:
        g = old_world // new_world
        folded = rows.reshape(new_world, g, old_width).mean(axis=1)
    elif new_world % old_world == 0:
        folded = np.repeat(rows, new_world // old_world, axis=0)
    else:
        raise ValueError(
            f"cannot re-place worker rows from world {old_world} to "
            f"{new_world}: one world size must divide the other")
    out = np.zeros((new_world, new_width), rows.dtype)
    m = min(old_width, new_width)
    out[:, :m] = folded[:, :m]
    return out


def refold_segment_rows(rows: np.ndarray, new_world: int,
                        new_seg: int) -> np.ndarray:
    """Per-segment-owner rows ``(old_world, old_seg)`` -> ``(new_world,
    new_seg)``, each position kept: the rows laid end to end are one
    vector over the flat parameters, re-cut at the new bounds."""
    rows = np.asarray(rows)
    if rows.ndim != 2:
        raise ValueError(f"segment rows must be 2-D, got {rows.shape}")
    flat = rows.reshape(-1)
    out = np.zeros(new_world * new_seg, rows.dtype)
    m = min(flat.size, out.size)
    out[:m] = flat[:m]
    return out.reshape(new_world, new_seg)


def _old_plan(plan: CommPlan, old_world: int) -> CommPlan:
    """The checkpoint's plan: the same gradient and knobs, the old
    world."""
    return make_plan(plan.n_params, world=old_world, mode=plan.mode,
                     bucket_size=plan.bucket_size, chunks=plan.chunks,
                     layout=plan.layout)


def _check_ef_widths(name: str, node: Dict[str, Any],
                     old: CommPlan) -> None:
    """The node must be a world-``old.world`` layout of this plan."""
    ef = np.asarray(node["ef_residual"])
    ef2 = np.asarray(node["ef_residual2"])
    ok = (ef.ndim == 2 and ef2.ndim == 2
          and ef.shape[0] == old.world and ef2.shape[0] == old.world
          and ef.shape[1] in (0, old.padded)
          and ef2.shape[1] in (0, old.seg))
    if not ok:
        raise ValueError(
            f"{name} rows {ef.shape}/{ef2.shape} do not match the "
            f"world-{old.world} plan (padded={old.padded}, seg={old.seg}): "
            "a checkpoint of another model or bucket configuration, not "
            "only of another world")


def _kind(node: Any):
    """"SignCompressState" / "FsdpCompressState" for a state-dict node
    of the 1-bit exchange, else None."""
    if not isinstance(node, dict):
        return None
    keys = set(node)
    if keys == _EF_KEYS:
        return "SignCompressState"
    if keys == _EF_KEYS | {"inner"}:
        return "FsdpCompressState"
    return None


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def remesh_compress_state(opt_state: Any, plan: CommPlan
                          ) -> Tuple[Any, int]:
    """Re-place every node of the 1-bit exchange in ``opt_state`` (a
    checkpoint's optimizer state in flax's state-dict layout, numpy
    leaves, written at another world) onto ``plan``'s world. Returns
    ``(new_opt_state, nodes_replaced)``; a node already at
    ``plan.world`` passes unchanged, so the call is idempotent, and
    zero-width rows (``sign`` mode) stay zero-width."""
    replaced = 0

    def fold(node):
        nonlocal replaced
        name = _kind(node)
        if name is None:
            if isinstance(node, dict):
                return {k: fold(v) for k, v in node.items()}
            return node
        old_world = int(np.asarray(node["ef_residual"]).shape[0])
        if old_world == plan.world:
            return node
        old = _old_plan(plan, old_world)
        _check_ef_widths(name, node, old)
        ef_w = plan.padded if np.asarray(node["ef_residual"]).shape[1] else 0
        ef2_w = plan.seg if np.asarray(node["ef_residual2"]).shape[1] else 0
        out = {"ef_residual": fold_worker_rows(node["ef_residual"],
                                               plan.world, ef_w),
               "ef_residual2": refold_segment_rows(node["ef_residual2"],
                                                   plan.world, ef2_w)}
        replaced += 1
        log.info("remesh: re-placed %s world %d -> %d (seg %d -> %d)", name,
                 old_world, plan.world, old.seg, plan.seg)
        if name == "SignCompressState":
            return out

        def fold_inner(leaf):
            arr = np.asarray(leaf)
            if arr.shape == (old_world, old.seg):
                return refold_segment_rows(arr, plan.world, plan.seg)
            if arr.ndim == 0 or arr.shape == (plan.world, plan.seg):
                return leaf
            raise ValueError(
                f"unexpected base-optimizer state leaf {arr.shape} in "
                f"{name}.inner (want ({old_world}, {old.seg}) segment rows "
                "or a scalar): cannot re-place")

        out["inner"] = _map_leaves(fold_inner, node["inner"])
        return out

    return fold(opt_state), replaced
