"""Packed 1-bit serving for the transformer families: freezing the
binarized LM and ViT, their full forwards, contiguous KV-cache decoding
and the paged decoder (with its speculative verify call) of the LM server.

Counterpart of the JAX package's ``infer_transformer.py``.
Every binarized projection (q/k/v/out and the MLP) drops its fp32 latent
and keeps its ±1 weights packed to bitplanes (``ops.prepack_weights``);
LayerNorm, the softmax attention core, residuals, embeddings and the head
stay fp32 as in the live eval forward. Activations are binarized on the
fly with the same deterministic sign (``sign(0) = +1``). The ViT's patch
embedding keeps ±1 weights on raw pixels (fp32 in memory, int8 on disk)
and no alpha, as the live model.

Which kernel runs a packed projection depends on its row count M, as in
the JAX package: below ``FUSED_UNPACK_MIN_M`` rows (the decode step, one
row per slot) the XNOR-popcount GEMM (K1), at or above it with the kernel
path armed (prefill chunks) the fused bitplane-unpack GEMM (K7). Both are
exact integer sums on ±1 inputs, so the choice cannot move a logit. The
paged decoder's attention runs K8, which walks the page table inside the
kernel. On a CUDA device every one of those is a hand-written kernel; on
the CPU the same routing reaches their plain versions.

The frozen artifact is a dict of plain tensors under the JAX package's
``_freeze_lm_tensors`` keys (hidden weights ``wp``/``k``/``n``/``bias``
and ``alpha`` when the model scales; fp32 ``kernel``/``bias`` for fp32
attention projections; kernels (in, out)). Decoders here are plain Python
callables over tensors: PyTorch runs eagerly, so there is no compile step
and no program to warm. The paged pools are updated in place.

Speculative decoding's verify call runs the packed projections the
drafts and the prefills run (K7 at ``FUSED_UNPACK_MIN_M`` rows or more,
K1 below: on ±1 inputs both give the exact integer sums) and K8's verify
entry.

Entry points take a ``device``, default ``"cuda"``; with no CUDA device
they raise unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .infer import resolve_device
from .models.layers import BinarizedDense
from .models.transformer import (
    BinarizedLM,
    BinarizedTransformer,
    _attend_xla,
    layer_norm,
)
from .ops import paged_kv
from .ops.binarize import binarize_ste
from .ops.xnor_gemm import (
    _xnor_matmul_binarize,
    prepack_weights,
    xnor_matmul_fused_unpack,
)

FAMILY = "bnn-transformer"

#: Row count M at which a packed projection on the kernel path switches
#: from the XNOR-popcount GEMM (K1) to the fused bitplane-unpack GEMM (K7),
#: the JAX package's value. Decode steps (M = slots) stay below it,
#: prefill chunks (M = prefill_chunk = 16) reach it.
FUSED_UNPACK_MIN_M = 16

#: Prompt positions per prefill dispatch (``generate`` and the paged
#: engine's default).
PREFILL_CHUNK = 16

_PROJ = ("q", "k", "v", "out", "mlp1", "mlp2")


# ---------------------------------------------------------------------------
# Freezing
# ---------------------------------------------------------------------------


def _freeze_dense(dense: BinarizedDense, scale: bool) -> Dict[str, Any]:
    """One hidden BinarizedDense -> packed bitplanes + fp32 bias (+ the
    XNOR-Net alpha, computed from the latent it replaces)."""
    w = dense.weight.detach()                     # (out, in)
    wp, k, n = prepack_weights(binarize_ste(w).t())
    out = {"wp": wp, "k": k, "n": n, "bias": dense.bias.detach()}
    if scale:
        out["alpha"] = w.abs().mean(dim=1)
    return out


def _freeze_dense_fp32(lin: torch.nn.Linear) -> Dict[str, Any]:
    """One fp32 projection (``binarized_attention=False``), carried as
    it is: kernel (in, out), bias. Marker: ``kernel`` instead of ``wp``."""
    return {"kernel": lin.weight.detach().t().contiguous(),
            "bias": lin.bias.detach()}


def _check_freezable(model, cls) -> None:
    """The JAX package's refusals: only binarized, deterministic models
    of the plain single-device topology freeze."""
    if not isinstance(model, cls):
        raise ValueError(f"need a {cls.__name__}, got {type(model)}")
    if not getattr(model, "binarized", True):
        raise ValueError(
            "packed freezing needs binarized weights; the fp32 twins have "
            "none to pack (serve them as live models)"
        )
    if any(getattr(m, "stochastic", False) for m in model.modules()):
        raise ValueError(
            "stochastic activation binarization is a train-time feature; "
            "freeze the deterministic eval path"
        )
    if any(blk.attn.attention_fn is not None for blk in model.blocks):
        raise ValueError(
            "attention_fn (ring/SP) is a training-topology override; "
            "freeze the plain single-device model"
        )


def _ln_dict(ln) -> Dict[str, torch.Tensor]:
    return {"scale": ln.weight.detach(), "bias": ln.bias.detach()}


def _freeze_blocks(model: BinarizedLM) -> list:
    blocks = []
    for blk in model.blocks:
        attn = blk.attn
        proj = [
            _freeze_dense(d, model.scale) if isinstance(d, BinarizedDense)
            else _freeze_dense_fp32(d)
            for d in (attn.q, attn.k, attn.v, attn.out)
        ]
        blocks.append({
            "ln_attn": _ln_dict(blk.ln_attn),
            "q": proj[0], "k": proj[1], "v": proj[2], "out": proj[3],
            "ln_mlp": _ln_dict(blk.ln_mlp),
            "mlp1": _freeze_dense(blk.mlp1, model.scale),
            "mlp2": _freeze_dense(blk.mlp2, model.scale),
        })
    return blocks


def _freeze_info(model, blocks: list, kind: str,
                 embed_w: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Size accounting, the JAX package's: fp32 latents of every
    binarized projection against the packed words (and the ViT's ±1
    patch embedding at 4 bytes a weight); fp32-carried kernels weigh the
    same on both sides."""
    latent = sum(
        m.weight.numel() * 4 for m in model.modules()
        if isinstance(m, BinarizedDense)
    )
    dense = sum(
        b[key]["kernel"].numel() * 4
        for b in blocks for key in _PROJ if "kernel" in b[key]
    )
    packed = sum(
        b[key].get("wp", b[key].get("kernel")).numel() * 4
        for b in blocks for key in _PROJ
    )
    if embed_w is not None:
        packed += embed_w.numel() * 4
    return {
        "family": FAMILY,
        "kind": kind,
        "latent_fp32_weight_bytes": latent + dense,
        "frozen_weight_bytes": packed,
        "compression": round((latent + dense) / packed, 2),
        "packed_layers": [
            f"TransformerBlock_{i}.{key}"
            for i, b in enumerate(blocks) for key in _PROJ if "wp" in b[key]
        ],
    }


@torch.no_grad()
def _freeze_lm_tensors(model: BinarizedLM) -> Dict[str, Any]:
    """The frozen LM artifact from a BinarizedLM's weights, under the
    JAX package's ``_freeze_lm_tensors`` keys and layouts."""
    _check_freezable(model, BinarizedLM)
    blocks = _freeze_blocks(model)
    return {
        "family": FAMILY,
        "kind": "lm",
        "num_heads": model.num_heads,
        "causal": True,
        "tok_embed": model.tok_embed.weight.detach(),
        "pos_embed": model.pos_embed.detach(),
        "blocks": blocks,
        "ln_head": _ln_dict(model.ln_head),
        "head_w": model.head.weight.detach().t().contiguous(),
        "head_b": model.head.bias.detach(),
        "info": _freeze_info(model, blocks, "lm"),
    }


@torch.no_grad()
def _freeze_vit_tensors(model: BinarizedTransformer) -> Dict[str, Any]:
    """The frozen ViT artifact, under the JAX package's
    ``_freeze_vit_tensors`` keys: the patch embedding's ±1 weights (in,
    out) on raw pixels with its bias (no alpha: the live model passes
    none), ``pos_embed``, the blocks, ``ln_head`` and the fp32 head."""
    _check_freezable(model, BinarizedTransformer)
    blocks = _freeze_blocks(model)
    w_embed = binarize_ste(model.patch_embed.weight.detach()).t().contiguous()
    return {
        "family": FAMILY,
        "kind": "vit",
        "patch_size": model.patch_size,
        "num_heads": model.num_heads,
        "causal": False,
        "w_embed": w_embed,
        "b_embed": model.patch_embed.bias.detach(),
        "pos_embed": model.pos_embed.detach(),
        "blocks": blocks,
        "ln_head": _ln_dict(model.ln_head),
        "head_w": model.head.weight.detach().t().contiguous(),
        "head_b": model.head.bias.detach(),
        "info": _freeze_info(model, blocks, "vit", embed_w=w_embed),
    }


# ---------------------------------------------------------------------------
# Layer closures
# ---------------------------------------------------------------------------


def _on(tree, device: torch.device):
    """Tensors of a frozen (sub)dict on ``device``: int32 packed words
    stay int32, everything else becomes fp32."""
    if torch.is_tensor(tree):
        dtype = torch.int32 if tree.dtype == torch.int32 else torch.float32
        return tree.to(device=device, dtype=dtype).contiguous()
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_on(v, device) for v in tree]
    if isinstance(tree, np.ndarray):
        return _on(torch.from_numpy(tree.copy()), device)
    return tree


def _packed_dense_fn(layer: Dict[str, Any], fused: bool = False) -> Callable:
    """sign(x) @ packed W (* alpha) + b over any leading shape.
    ``fused`` (the kernel path) picks K7 at ``FUSED_UNPACK_MIN_M`` rows
    or more, K1 below; without it every call takes K1."""
    wp, bias, alpha = layer["wp"], layer["bias"], layer.get("alpha")
    k, n = int(layer["k"]), int(layer["n"])

    def fn(x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        flat = x.reshape(-1, k)
        if fused and flat.shape[0] >= FUSED_UNPACK_MIN_M:
            y = xnor_matmul_fused_unpack(binarize_ste(flat), wp, k, n)
        else:
            # binarize_ste then xnor_matmul_packed, bit for bit: K1 packs
            # the signs itself
            y = _xnor_matmul_binarize(flat, wp, k, n)
        y = y.reshape(*lead, n)
        if alpha is not None:
            y = y * alpha
        return y + bias

    return fn


def _dense_fn(layer: Dict[str, Any], fused: bool = False) -> Callable:
    """Packed 1-bit (``wp``) or carried fp32 (``kernel``) projection."""
    if "wp" in layer:
        return _packed_dense_fn(layer, fused)
    kernel, bias = layer["kernel"], layer["bias"]
    return lambda x: x @ kernel + bias


def _ln_fn(params: Dict[str, torch.Tensor]) -> Callable:
    """flax LayerNorm over frozen scale/bias (``models.layer_norm``)."""
    scale, bias = params["scale"], params["bias"]
    return lambda y: layer_norm(y, scale, bias)


def _block_layers(blk: Dict[str, Any], fused: bool = False) -> Dict[str, Callable]:
    """The per-block closures shared by every forward below."""
    lay = {"ln_attn": _ln_fn(blk["ln_attn"]), "ln_mlp": _ln_fn(blk["ln_mlp"])}
    for key in _PROJ:
        lay[key] = _dense_fn(blk[key], fused)
    return lay


def _mlp(lay: Dict[str, Callable], x: torch.Tensor) -> torch.Tensor:
    y = torch.nn.functional.hardtanh(lay["mlp1"](lay["ln_mlp"](x)))
    return x + lay["mlp2"](y)


def _block_fn(blk: Dict[str, Any], num_heads: int, causal: bool) -> Callable:
    lay = _block_layers(blk)

    def fn(x: torch.Tensor) -> torch.Tensor:
        b, t, e = x.shape
        d = e // num_heads
        y = lay["ln_attn"](x)
        q = lay["q"](y).reshape(b, t, num_heads, d)
        k = lay["k"](y).reshape(b, t, num_heads, d)
        v = lay["v"](y).reshape(b, t, num_heads, d)
        core = _attend_xla(q, k, v, causal=causal)
        x = x + lay["out"](core.reshape(b, t, e))
        return _mlp(lay, x)

    return fn


def _exact_fp32() -> None:
    """TF32 off for fp32 products on the card: the head, the fp32
    attention einsums and K7's plain version run at full fp32, as the
    JAX reference does (``Precision.HIGHEST``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Frozen:
    """Embeddings, head and device of a frozen LM artifact."""

    def __init__(self, frozen: Dict[str, Any], device):
        if frozen.get("kind") != "lm":
            raise ValueError(
                f"need a kind='lm' artifact, got {frozen.get('kind')!r}"
            )
        self.device = resolve_device(device)
        _exact_fp32()
        self.num_heads = int(frozen["num_heads"])
        self.tok = _on(frozen["tok_embed"], self.device)
        self.pos = _on(frozen["pos_embed"], self.device)[0]   # (L, E)
        self.ln_head = _ln_fn(_on(frozen["ln_head"], self.device))
        self.head_w = _on(frozen["head_w"], self.device)
        self.head_b = _on(frozen["head_b"], self.device)
        self.blocks = _on(frozen["blocks"], self.device)
        self.vocab, self.embed_dim = self.tok.shape
        self.pos_len = self.pos.shape[0]
        self.head_dim = self.embed_dim // self.num_heads

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.ln_head(x) @ self.head_w + self.head_b,
                                 dim=-1)

    def long(self, a) -> torch.Tensor:
        """Token ids (numpy, list or tensor) as int64 on the device."""
        return self._tensor(a, torch.int64)

    def int32(self, a) -> torch.Tensor:
        """Page tables and positions as int32 on the device."""
        return self._tensor(a, torch.int32)

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        if not torch.is_tensor(a):
            a = torch.from_numpy(np.asarray(a))
        return a.to(device=self.device, dtype=dtype)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


class FrozenLM:
    """Packed full-window predictor: ``fn(tokens (B, T)) -> (B, T,
    vocab)`` log-probs on the predictor's device (numpy or torch
    tokens). Packed projections take K1 at every M, as the JAX full
    forward does."""

    def __init__(self, frozen: Dict[str, Any], device):
        self.f = _Frozen(frozen, device)
        self.device = self.f.device
        self.blocks = [
            _block_fn(blk, self.f.num_heads, bool(frozen["causal"]))
            for blk in self.f.blocks
        ]

    @torch.no_grad()
    def __call__(self, tokens) -> torch.Tensor:
        tokens = self.f.long(tokens)
        t = tokens.shape[1]
        if t > self.f.pos_len:
            raise ValueError(f"sequence length {t} > max_len {self.f.pos_len}")
        x = self.f.tok[tokens] + self.f.pos[:t]
        for blk in self.blocks:
            x = blk(x)
        return self.f.head(x)


class FrozenViT:
    """Packed ViT classifier: ``fn(images) -> (B, classes)`` log-probs on
    the predictor's device, for (B, H, W, C) images or (B, H*W*C) flat
    ones (numpy or torch). Patches are cut in flax's (row, col, (py, px,
    c)) order, embedded by the ±1 patch weights on raw pixels, and the
    tokens are mean-pooled after ``ln_head``. Every packed projection
    runs K1 (the JAX package builds them unfused); the attention core is
    the exact softmax."""

    def __init__(self, frozen: Dict[str, Any], device):
        if frozen.get("kind", "vit") != "vit":
            raise ValueError(
                f"need a kind='vit' artifact, got {frozen.get('kind')!r}"
            )
        self.device = resolve_device(device)
        _exact_fp32()
        self.num_heads = int(frozen["num_heads"])
        self.patch = int(frozen["patch_size"])
        self.w_embed = _on(frozen["w_embed"], self.device)   # disk: int8
        self.b_embed = _on(frozen["b_embed"], self.device)
        self.pos = _on(frozen["pos_embed"], self.device)    # (1, T, E)
        self.ln_head = _ln_fn(_on(frozen["ln_head"], self.device))
        self.head_w = _on(frozen["head_w"], self.device)
        self.head_b = _on(frozen["head_b"], self.device)
        self.n_tokens = self.pos.shape[1]
        self.channels = self.w_embed.shape[0] // (self.patch * self.patch)
        self.blocks = [
            _block_fn(blk, self.num_heads, bool(frozen["causal"]))
            for blk in _on(frozen["blocks"], self.device)
        ]

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        x = images.to(device=self.device, dtype=torch.float32)
        p = self.patch
        if x.dim() == 2:
            side = int(round(self.n_tokens ** 0.5)) * p
            x = x.reshape(x.shape[0], side, side, self.channels)
        b, h, w, c = x.shape
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch size {p}")
        nh, nw = h // p, w // p
        if nh * nw != self.n_tokens:
            raise ValueError(
                f"input {h}x{w} yields {nh * nw} patch tokens but the "
                f"artifact's pos_embed was trained for {self.n_tokens}"
            )
        x = x.reshape(b, nh, p, nw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, nh * nw, p * p * c) @ self.w_embed
        x = x + self.b_embed + self.pos
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_head(x).mean(dim=1)
        return torch.log_softmax(x @ self.head_w + self.head_b, dim=-1)


def _build_transformer_apply(frozen: Dict[str, Any], device):
    """Frozen forward from a ``bnn-transformer`` artifact (in memory or
    loaded from disk): ``FrozenLM`` for ``kind == "lm"``, ``FrozenViT``
    for ``"vit"`` (the JAX package's default when the key is absent)."""
    kind = frozen.get("kind", "vit")
    if kind == "lm":
        return FrozenLM(frozen, device)
    if kind == "vit":
        return FrozenViT(frozen, device)
    raise ValueError(f"unknown bnn-transformer kind {kind!r}")


def freeze_bnn_vit(
    model: BinarizedTransformer, *, device="cuda"
) -> Tuple[FrozenViT, Dict[str, Any]]:
    """Freeze a binarized ViT into a packed classifier on ``device``,
    computing what ``model.eval()(images)`` computes. Returns (fn, size
    info)."""
    frozen = _freeze_vit_tensors(model)
    return _build_transformer_apply(frozen, device), frozen["info"]


def freeze_bnn_lm(
    model: BinarizedLM, *, device="cuda"
) -> Tuple[FrozenLM, Dict[str, Any]]:
    """Freeze a BinarizedLM into packed next-token inference on
    ``device``: ``fn(tokens) -> (B, T, vocab)`` log-probs, computing what
    ``model.eval()(tokens)`` computes. Returns (fn, size info)."""
    frozen = _freeze_lm_tensors(model)
    return _build_transformer_apply(frozen, device), frozen["info"]


# ---------------------------------------------------------------------------
# Contiguous KV-cache decoding
# ---------------------------------------------------------------------------


def _block_decode_fn(blk, num_heads: int) -> Callable:
    """One block's single-position step against a (B, L, H, D) cache:
    ``fn(x (B, E), kc, vc, pos) -> x``; the cache is written in place.
    Positions > ``pos`` are masked out of the softmax."""
    lay = _block_layers(blk)

    def fn(x, kc, vc, pos: int):
        b, e = x.shape
        d = e // num_heads
        y = lay["ln_attn"](x)
        q = lay["q"](y).reshape(b, num_heads, d)
        kc[:, pos] = lay["k"](y).reshape(b, num_heads, d)
        vc[:, pos] = lay["v"](y).reshape(b, num_heads, d)
        scores = torch.einsum("bhd,blhd->bhl", q, kc) * d ** -0.5
        mask = torch.arange(kc.shape[1], device=x.device) <= pos
        scores = scores.masked_fill(~mask, float("-inf"))
        core = torch.einsum("bhl,blhd->bhd", torch.softmax(scores, -1), vc)
        x = x + lay["out"](core.reshape(b, e))
        return _mlp(lay, x)

    return fn


def _block_chunk_fn(blk, num_heads: int) -> Callable:
    """One block's chunked-prefill step: ``fn(x (B, C, E), kc, vc,
    start) -> x`` writes C positions at [start, start + C) and attends
    causally over the whole cache strip. Its K/V rows equal C
    single-position steps' (projections are per token)."""
    lay = _block_layers(blk)

    def fn(x, kc, vc, start: int):
        b, c, e = x.shape
        d = e // num_heads
        y = lay["ln_attn"](x)
        q = lay["q"](y).reshape(b, c, num_heads, d)
        kc[:, start:start + c] = lay["k"](y).reshape(b, c, num_heads, d)
        vc[:, start:start + c] = lay["v"](y).reshape(b, c, num_heads, d)
        scores = torch.einsum("bchd,blhd->bchl", q, kc) * d ** -0.5
        qpos = start + torch.arange(c, device=x.device)
        mask = torch.arange(kc.shape[1], device=x.device)[None, :] \
            <= qpos[:, None]
        scores = scores.masked_fill(~mask[None, :, None, :], float("-inf"))
        core = torch.einsum("bchl,blhd->bchd", torch.softmax(scores, -1), vc)
        x = x + lay["out"](core.reshape(b, c, e))
        return _mlp(lay, x)

    return fn


def make_lm_decoder(
    frozen: Dict[str, Any], *, max_len: Optional[int] = None, device="cuda",
) -> Tuple[Callable, Callable]:
    """Incremental (KV-cached) decoding from a frozen LM artifact.

    Returns ``(init_caches, step)``:
      * ``init_caches(batch)`` -> zeroed per-block (B, L, H, D) K/V
        pairs, L = ``max_len`` or the artifact's window;
      * ``step(caches, tokens (B,), pos) -> (caches, log_probs (B,
        vocab))``, the caches written in place;
      * ``step.prefill(caches, tokens (B, C), start) -> (caches,
        log_probs (B, C, vocab))``, C prompt positions at once
        (``start + C <= L``).
    """
    f = _Frozen(frozen, device)
    cache_len = f.pos_len if max_len is None else int(max_len)
    if not 1 <= cache_len <= f.pos_len:
        raise ValueError(
            f"max_len {cache_len} outside [1, trained pos_embed length "
            f"{f.pos_len}]"
        )
    blocks = [_block_decode_fn(b, f.num_heads) for b in f.blocks]
    chunk_blocks = [_block_chunk_fn(b, f.num_heads) for b in f.blocks]

    def init_caches(batch: int):
        shape = (batch, cache_len, f.num_heads, f.head_dim)
        return tuple(
            (torch.zeros(shape, device=f.device),
             torch.zeros(shape, device=f.device))
            for _ in blocks
        )

    @torch.no_grad()
    def step(caches, tokens, pos: int):
        pos = int(pos)
        if not 0 <= pos < cache_len:
            raise ValueError(f"decode position {pos} outside [0, {cache_len})")
        x = f.tok[f.long(tokens)] + f.pos[pos]
        for blk, (kc, vc) in zip(blocks, caches):
            x = blk(x, kc, vc, pos)
        return caches, f.head(x)

    @torch.no_grad()
    def prefill(caches, tokens, start: int):
        tokens = f.long(tokens)
        start, c = int(start), tokens.shape[1]
        if start < 0 or start + c > cache_len:
            raise ValueError(
                f"prefill [{start}, {start + c}) outside [0, {cache_len})"
            )
        x = f.tok[tokens] + f.pos[start:start + c]
        for blk, (kc, vc) in zip(chunk_blocks, caches):
            x = blk(x, kc, vc, start)
        return caches, f.head(x)

    init_caches.cache_len = cache_len
    step.cache_len = cache_len
    step.prefill = prefill
    return init_caches, step


def generate(
    frozen: Dict[str, Any], prompt, n_tokens: int, *,
    temperature: float = 0.0, generator: Optional[torch.Generator] = None,
    decoder: Optional[Tuple[Callable, Callable]] = None, device="cuda",
) -> torch.Tensor:
    """Autoregressive generation through the KV-cache decoder: prefill
    the prompt in ``PREFILL_CHUNK`` chunks and the sub-chunk tail one
    position at a time, then emit ``n_tokens``: greedy at
    ``temperature=0``, else sampled from softmax(lp / temperature) with
    ``generator`` (a CPU ``torch.Generator``).

    ``prompt``: (B, P) int tokens. Returns (B, P + n_tokens) int64 on the
    CPU. Serving loops build ``decoder=make_lm_decoder(frozen)`` once
    and pass it."""
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64)
    if prompt.dim() != 2 or prompt.shape[1] < 1:
        raise ValueError(f"prompt must be (B, P>=1), got {tuple(prompt.shape)}")
    if n_tokens < 0:
        raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
    if temperature < 0:
        raise ValueError(
            f"temperature must be >= 0 (0 = greedy), got {temperature}"
        )
    init, step = decoder or make_lm_decoder(frozen, device=device)
    total = prompt.shape[1] + n_tokens
    if total > step.cache_len:
        raise ValueError(
            f"prompt {prompt.shape[1]} + n_tokens {n_tokens} = {total} "
            f"exceeds the decoder's cache length {step.cache_len}"
        )
    caches = init(prompt.shape[0])
    lp = None
    t = 0
    while t + PREFILL_CHUNK <= prompt.shape[1]:
        caches, clp = step.prefill(caches, prompt[:, t:t + PREFILL_CHUNK], t)
        lp = clp[:, -1]
        t += PREFILL_CHUNK
    for t in range(t, prompt.shape[1]):
        caches, lp = step(caches, prompt[:, t], t)
    out = [prompt]
    for t in range(prompt.shape[1], total):
        lp_host = lp.cpu()
        if temperature > 0:
            probs = torch.softmax(lp_host / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = lp_host.argmax(dim=-1)
        out.append(nxt[:, None])
        if t < total - 1:
            caches, lp = step(caches, nxt, t)
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Paged KV-cache decoding (continuous batching, serve/lm/)
# ---------------------------------------------------------------------------


class PagedLMDecoder(NamedTuple):
    """The two calls behind the continuous-batching engine and their
    fixed geometry (the JAX package's NamedTuple, field for field):

      * ``prefill(pools, tokens (C,), page_table (P,), start, length)``
        -> ``(pools, log_probs (C, vocab))``: one sequence's prompt
        chunk; K/V written through the page table (positions >=
        ``length`` go to the null page), causal attention over the
        table, per-position next-token log-probs;
      * ``decode(pools, tokens (S,), page_tables (S, P), positions
        (S,))`` -> ``(pools, log_probs (S, vocab))``: one iteration for
        all S slots; inactive slots carry all-null tables and their rows
        are ignored.

      * ``verify(pools, tokens (S, K), page_tables (S, P), positions
        (S,))`` -> ``(pools, log_probs (S, K, vocab))``, with ``spec_k =
        K > 0``: the speculative scorer. K consecutive tokens a slot from
        its base position, their K/V written over what the drafts wrote,
        causal log-probs at every position, the projections those of
        ``decode`` and ``prefill`` (S x K rows) and the attention through
        K8's verify entry. K is fixed at build time; acceptance is the
        engine's, on the host.

    Arguments may be numpy arrays, ints or tensors; the pools are
    updated in place and returned."""

    init_pools: Callable
    prefill: Callable
    decode: Callable
    slots: int
    page_size: int
    num_pages: int
    max_pages: int          # page-table width (pages per sequence)
    max_len: int            # longest sequence (prompt + generated)
    prefill_chunk: int
    vocab: int
    num_blocks: int
    verify: Optional[Callable] = None
    spec_k: int = 0         # verify window (0: no speculative decoding)
    kernels: bool = True    # K8 attention + K7 prefill projections


def make_paged_lm_decoder(
    frozen: Dict[str, Any], *,
    slots: int,
    page_size: int = 16,
    num_pages: Optional[int] = None,
    prefill_chunk: int = PREFILL_CHUNK,
    max_len: Optional[int] = None,
    spec_k: int = 0,
    kernels: bool = True,
    device="cuda",
) -> PagedLMDecoder:
    """Build the paged prefill/decode pair from a ``kind == "lm"``
    artifact (see :class:`PagedLMDecoder`). ``num_pages`` defaults to
    enough for every slot to reach ``max_len`` at once, plus the null
    page.

    ``kernels=True`` (the default) is the serving path: attention walks
    the page table in K8, and every packed projection of M >=
    ``FUSED_UNPACK_MIN_M`` rows runs K7 (K1 below). ``kernels=False``
    runs the gather path and K1 everywhere: the plain versions, for the
    CPU only; on a CUDA device it raises. ``spec_k > 0`` also builds
    ``verify``: the engine drafts ``spec_k - 1`` tokens through
    ``decode`` and scores the window in one ``verify`` call; ``spec_k ==
    1`` is the verifier alone (no drafts), the reference engine."""
    spec_k = int(spec_k)
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    kernels = bool(kernels)
    dev = resolve_device(device)
    if not kernels and dev.type == "cuda":
        raise ValueError(
            "kernels=False is the gather path, the plain version of the "
            "paged decoder; on a CUDA device the decoder runs the kernels"
        )
    f = _Frozen(frozen, dev)
    layers = [_block_layers(blk, fused=kernels) for blk in f.blocks]
    if kernels:
        attn = paged_kv.paged_attention_kernel
        attn_prefill = paged_kv.paged_prefill_attention_kernel
        attn_verify = paged_kv.paged_verify_attention_kernel
    else:
        attn = paged_kv.paged_attention
        attn_prefill = paged_kv.paged_prefill_attention
        attn_verify = paged_kv.paged_verify_attention
    max_len = f.pos_len if max_len is None else int(max_len)
    if not 1 <= max_len <= f.pos_len:
        raise ValueError(
            f"max_len {max_len} outside [1, trained pos_embed length "
            f"{f.pos_len}]"
        )
    slots, page_size = int(slots), int(page_size)
    prefill_chunk = int(prefill_chunk)
    if slots < 1:
        raise ValueError(f"need >= 1 batch slot, got {slots}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if prefill_chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
    max_pages = paged_kv.pages_needed(max_len, page_size)
    if num_pages is None:
        num_pages = slots * max_pages + 1        # +1: the null page
    num_pages = int(num_pages)
    h, d, e = f.num_heads, f.head_dim, f.embed_dim

    def init_pools():
        return paged_kv.init_pools(
            len(layers), num_pages, page_size, h, d, device=f.device
        )

    def _embed(tokens: torch.Tensor, gpos: torch.Tensor) -> torch.Tensor:
        return f.tok[tokens] + f.pos[gpos.long().clamp(0, f.pos_len - 1)]

    @torch.no_grad()
    def prefill(pools, tokens, page_table, start, length):
        tokens, table = f.long(tokens), f.int32(page_table)
        c = tokens.shape[0]
        gpos = int(start) + torch.arange(c, dtype=torch.int32, device=f.device)
        idx = paged_kv.flat_write_indices(
            table, gpos, page_size, valid=gpos < int(length)
        )
        x = _embed(tokens, gpos)
        for lay, (kp, vp) in zip(layers, pools):
            y = lay["ln_attn"](x)
            paged_kv.write_kv(kp, idx, lay["k"](y).reshape(c, h, d))
            paged_kv.write_kv(vp, idx, lay["v"](y).reshape(c, h, d))
            core = attn_prefill(lay["q"](y).reshape(c, h, d), kp, vp,
                                table, gpos)
            x = _mlp(lay, x + lay["out"](core.reshape(c, e)))
        return pools, f.head(x)

    @torch.no_grad()
    def decode(pools, tokens, page_tables, positions):
        tokens, tables = f.long(tokens), f.int32(page_tables)
        positions = f.int32(positions)
        s = tokens.shape[0]
        idx = paged_kv.flat_write_indices(tables, positions, page_size)
        x = _embed(tokens, positions)
        for lay, (kp, vp) in zip(layers, pools):
            y = lay["ln_attn"](x)
            paged_kv.write_kv(kp, idx, lay["k"](y).reshape(s, h, d))
            paged_kv.write_kv(vp, idx, lay["v"](y).reshape(s, h, d))
            core = attn(lay["q"](y).reshape(s, h, d), kp, vp, tables,
                        positions)
            x = _mlp(lay, x + lay["out"](core.reshape(s, e)))
        return pools, f.head(x)

    verify = None
    if spec_k:
        @torch.no_grad()
        def verify(pools, tokens, page_tables, positions):
            tokens, tables = f.long(tokens), f.int32(page_tables)
            positions = f.int32(positions)
            s, kw = tokens.shape
            qpos = positions[:, None] + torch.arange(
                kw, dtype=torch.int32, device=f.device)[None, :]
            idx = paged_kv.flat_write_indices(
                tables[:, None, :].expand(s, kw, tables.shape[-1]), qpos,
                page_size)
            x = _embed(tokens, qpos)
            for lay, (kp, vp) in zip(layers, pools):
                y = lay["ln_attn"](x)
                paged_kv.write_kv(kp, idx, lay["k"](y).reshape(s, kw, h, d))
                paged_kv.write_kv(vp, idx, lay["v"](y).reshape(s, kw, h, d))
                core = attn_verify(lay["q"](y).reshape(s, kw, h, d), kp, vp,
                                   tables, positions)
                x = _mlp(lay, x + lay["out"](core.reshape(s, kw, e)))
            return pools, f.head(x)

    return PagedLMDecoder(
        init_pools=init_pools,
        prefill=prefill,
        decode=decode,
        slots=slots,
        page_size=page_size,
        num_pages=num_pages,
        max_pages=max_pages,
        max_len=max_len,
        prefill_chunk=prefill_chunk,
        vocab=f.vocab,
        num_blocks=len(layers),
        verify=verify,
        spec_k=spec_k,
        kernels=kernels,
    )
