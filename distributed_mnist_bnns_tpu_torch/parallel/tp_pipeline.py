"""The three-axis DP x TP x PP composition: Megatron tensor parallelism
inside each pipeline stage, data parallelism across replica rows (the
JAX package's ``parallel/tp_pipeline.py``).

Each stage is a binarized two-matmul MLP block in the column -> row
Megatron layout over the 'model' axis:

    h = hardtanh(x @ sign(W1_col) + b1_col)   # local: no collective
    y = sum_model(h @ sign(W2_row)) + b2      # one all-reduce a stage

W1 is column-parallel (each model rank holds hidden/tp columns), W2
row-parallel (hidden/tp rows), so the one model-axis collective is the
all-reduce of the row-parallel partials (``model_parallel.
reduce_from_model``; ``copy_to_model`` in front of W1 all-reduces the
input's gradient in backward). The stage chain runs through the GPipe
schedule of ``make_pipeline_fn`` over 'pipe' within each (data, model)
line, and the batch is this data row's rows; the gradient all-reduce
over 'data' is the caller's.

``x @ sign(W)`` is a dense product here, as in JAX, which computes it
with ``jnp.dot`` outside any Pallas kernel: ``torch.matmul`` of fp32
operands (+-1 weights).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.binarize import binarize_ste
from ..ops.comm_compress import WireBytes
from ..models.layers import hard_tanh
from .mesh import Mesh, P
from .model_parallel import copy_to_model, reduce_from_model


def init_tp_pipeline_params(generator: torch.Generator, n_stages: int,
                            d_model: int, d_hidden: int) -> Dict[str,
                                                                 torch.Tensor]:
    """Stage-major (dim 0 = stage) full-shape params of the TP-MLP chain:
    w1 (S, d, h) uniform in +-1/sqrt(d), b1 (S, h) zeros, w2 (S, h, d)
    uniform, b2 (S, d) zeros (JAX's shapes and ranges; the draws are
    torch's)."""
    s = 1.0 / d_model ** 0.5

    def uniform(*shape):
        return torch.empty(shape).uniform_(-s, s, generator=generator)

    return {"w1": uniform(n_stages, d_model, d_hidden),
            "b1": torch.zeros(n_stages, d_hidden),
            "w2": uniform(n_stages, d_hidden, d_model),
            "b2": torch.zeros(n_stages, d_model)}


def tp_pipeline_param_specs(axis: str = "pipe",
                            model_axis: str = "model") -> Dict[str, P]:
    """Per-leaf placement: dim 0 the pipeline stage, the hidden dim TP."""
    return {"w1": P(axis, None, model_axis),   # column-parallel
            "b1": P(axis, model_axis),
            "w2": P(axis, model_axis, None),   # row-parallel
            "b2": P(axis, None)}               # replicated over model


def make_tp_pipeline_fn(mesh: Mesh, *, axis: str = "pipe",
                        model_axis: str = "model",
                        batch_axis: Optional[str] = "data",
                        n_micro: int = 0, stage_remat: bool = False,
                        wire: Optional[WireBytes] = None):
    """``f(stage_params, x) -> y``: the stage chain pipelined over
    ``axis`` with Megatron TP over ``model_axis`` inside every stage and
    ``x`` this ``batch_axis`` row's rows. ``stage_params`` leaves are
    the full shapes of ``init_tp_pipeline_params``; each rank takes its
    slice per ``tp_pipeline_param_specs``."""
    from .pipeline import make_pipeline_fn

    group = mesh.group(model_axis)

    def stage_fn(params, x):
        x = copy_to_model(x, group, wire)
        h = hard_tanh(torch.matmul(x, binarize_ste(params["w1"]))
                      + params["b1"])
        partial = torch.matmul(h, binarize_ste(params["w2"]))
        return reduce_from_model(partial, group, wire) + params["b2"]

    if batch_axis is not None and batch_axis not in mesh.axis_names:
        batch_axis = None
    return make_pipeline_fn(
        mesh, stage_fn, axis=axis, n_micro=n_micro or mesh.size(axis),
        batch_axis=batch_axis, stage_remat=stage_remat,
        param_specs=tp_pipeline_param_specs(axis, model_axis), wire=wire)


def tp_pipeline_reference(stage_params: Dict[str, torch.Tensor],
                          x: torch.Tensor) -> torch.Tensor:
    """One-process dense oracle (same binarize, unsharded products)."""
    for s in range(stage_params["w1"].shape[0]):
        h = torch.matmul(x, binarize_ste(stage_params["w1"][s]))
        h = hard_tanh(h + stage_params["b1"][s])
        x = (torch.matmul(h, binarize_ste(stage_params["w2"][s]))
             + stage_params["b2"][s])
    return x


def latent_mask(stage_params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """The clamp mask of the latent fp32 masters: weight leaves (w*)
    True, biases False."""
    return {k: k.startswith("w") for k in stage_params}
