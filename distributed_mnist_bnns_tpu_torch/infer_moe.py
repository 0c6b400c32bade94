"""Packed 1-bit serving for the MoE family (the JAX package's
``infer_moe.py``).

What folds and what stays live follows the family's routing:

  * the first BinarizedDense: ±1 weights on raw pixels (an fp32 GEMM),
    then BatchNorm as the eval affine and hardtanh: the fp32 router
    reads that continuous stream, so this BN does not fold into a sign;
  * the router: fp32 GEMM, softmax and ``ops.routing.topk_dispatch``,
    the live model's routing, with capacity from the rows the predictor
    is given (a server's padded micro-batch: padded rows take slots, as
    in the JAX server);
  * the experts: each expert's (D, Do) ±1 weights as prepacked
    bitplanes, stacked (E, KW_p, N_p); the slot inputs are binarized
    (an empty slot's 0 reads +1 and is combined with weight 0) and each
    expert runs K1 (``xnor_matmul_packed``) plus its bias;
  * the combine, then ``binarize(hardtanh(BN(y)))`` folded into the
    threshold compare, the packed head on K1 and log_softmax.

A served batch launches K1 E + 1 times on a card; the CPU runs K1's
plain version. The artifact is the JAX ``bnn-moe-mlp`` dict (``w1`` as
int8 on disk).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .infer import (
    _bn_affine_params,
    _bn_dict,
    _bn_sign_epilogue,
    _on,
    resolve_device,
)
from .models.layers import hard_tanh
from .models.moe import BnnMoEMLP, capacity_for
from .ops.binarize import binarize_ste
from .ops.routing import topk_dispatch
from .ops.xnor_gemm import _fma_f32, prepack_weights, xnor_matmul_packed

FAMILY = "bnn-moe-mlp"


@torch.no_grad()
def _freeze_moe_tensors(model: BnnMoEMLP) -> Dict[str, Any]:
    """The frozen dict of a BnnMoEMLP (the JAX ``_freeze_moe_tensors``)."""
    ex_w = model.experts.w.detach()                      # (E, D, Do)
    packed = [prepack_weights(binarize_ste(w)) for w in ex_w]
    wp = torch.stack([p[0] for p in packed])             # (E, KWp, Np)
    head_wp, head_k, head_n = prepack_weights(
        binarize_ste(model.head.weight.detach()).t())
    frozen: Dict[str, Any] = {
        "family": FAMILY,
        "num_experts": model.num_experts,
        "router_k": model.router_k,
        "capacity_factor": model.capacity_factor,
        "w1": binarize_ste(model.fc1.weight.detach()).t().contiguous(),
        "b1": model.fc1.bias.detach(),
        "bn0": _bn_dict(model.bn1),
        "router_w": model.router.weight.detach().t().contiguous(),
        "router_b": model.router.bias.detach(),
        "experts_wp": wp,
        "experts_k": packed[0][1],
        "experts_n": packed[0][2],
        "experts_b": model.experts.b.detach(),
        "bn1": _bn_dict(model.bn2),
        "head_wp": head_wp,
        "head_k": head_k,
        "head_n": head_n,
        "head_b": model.head.bias.detach(),
    }
    latent = (model.fc1.weight.numel() + ex_w.numel()
              + model.head.weight.numel()) * 4
    packed_bytes = (frozen["w1"].numel() + wp.numel()
                    + head_wp.numel()) * 4
    frozen["info"] = {
        "family": FAMILY,
        "latent_fp32_weight_bytes": latent,
        "frozen_weight_bytes": packed_bytes,
        "compression": round(latent / packed_bytes, 2),
        "packed_layers": ["BinarizedExperts_0", "BinarizedDense_1"],
    }
    return frozen


class FrozenMoE:
    """The packed routed predictor: ``predictor(images) -> log-probs`` (a
    tensor on the predictor's device) for (B, ...) images."""

    def __init__(self, frozen: Dict[str, Any], device: torch.device):
        if frozen.get("family") != FAMILY:
            raise ValueError(
                f"not a {FAMILY} artifact: {frozen.get('family')!r}")
        self.device = device
        self.num_experts = int(frozen["num_experts"])
        self.router_k = int(frozen["router_k"])
        self.capacity_factor = float(frozen["capacity_factor"])

        def f32(key):
            return frozen[key].to(device=device, dtype=torch.float32)

        self.w1, self.b1 = f32("w1"), f32("b1")
        self.a0, self.c0 = _bn_affine_params(
            _on(frozen["bn0"]["params"], device),
            _on(frozen["bn0"]["stats"], device))
        self.router_w, self.router_b = f32("router_w"), f32("router_b")
        self.experts_wp = frozen["experts_wp"].to(device).contiguous()
        self.ek, self.en = int(frozen["experts_k"]), int(frozen["experts_n"])
        self.experts_b = f32("experts_b")
        self.a1, self.t1 = _bn_sign_epilogue(
            _on(frozen["bn1"]["params"], device),
            _on(frozen["bn1"]["stats"], device))
        self.head_wp = frozen["head_wp"].to(device).contiguous()
        self.hk, self.hn = int(frozen["head_k"]), int(frozen["head_n"])
        self.head_b = f32("head_b")

    def capacity(self, tokens: int) -> int:
        return capacity_for(tokens, self.num_experts, self.router_k,
                            self.capacity_factor)

    def route(self, images) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """(hidden stream x (T, D), dispatch, combine) of ``images``."""
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        x = images.to(device=self.device, dtype=torch.float32)
        x = x.reshape(x.shape[0], -1) @ self.w1 + self.b1
        x = hard_tanh(_fma_f32(self.a0, x, self.c0))
        gates = torch.softmax(x @ self.router_w + self.router_b, dim=-1)
        dispatch, combine = topk_dispatch(gates, self.capacity(x.shape[0]),
                                          self.router_k)
        return x, dispatch, combine

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        x, dispatch, combine = self.route(images)
        xb = binarize_ste(torch.einsum("tec,td->ecd", dispatch, x))
        ex_out = torch.stack([
            xnor_matmul_packed(xb[e], self.experts_wp[e], self.ek, self.en)
            + self.experts_b[e] for e in range(self.num_experts)])
        y = torch.einsum("tec,ecd->td", combine, ex_out)
        bits = torch.where(self.a1 * y >= self.t1, 1.0, -1.0)
        logits = xnor_matmul_packed(bits, self.head_wp, self.hk,
                                    self.hn) + self.head_b
        return torch.log_softmax(logits, dim=-1)


def _build_moe_apply(frozen: Dict[str, Any], device) -> FrozenMoE:
    """The routed predictor of a frozen dict, TF32 off (the first layer
    and the router are fp32 GEMMs)."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    return FrozenMoE(frozen, dev)


def freeze_bnn_moe(model: BnnMoEMLP, *, device="cuda"
                   ) -> Tuple[FrozenMoE, Dict[str, Any]]:
    """Freeze a BnnMoEMLP into the packed routed predictor on ``device``;
    it computes what ``model.eval()(images)`` does on the same rows (up
    to fp32 summation order in the first layer and the router, and
    threshold ties)."""
    frozen = _freeze_moe_tensors(model)
    return _build_moe_apply(frozen, device), frozen["info"]
