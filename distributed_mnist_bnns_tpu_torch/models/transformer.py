"""The transformer family: the binarized causal language model and the
binarized vision transformer.

Counterpart of the JAX package's ``models/transformer.py`` for
``BinarizedLM``, ``BinarizedTransformer`` (the ViT: ``bnn_vit_tiny``,
``bnn_vit_small`` and their fp32 twins) and the pieces they are built
from: every projection of a
block (q, k, v, out and the two MLP layers) has binarized weights with
fp32 latents and binarizes its input; the token and position
embeddings, LayerNorm, the softmax attention core, the residual stream
and the head stay fp32.

``attention="xla"`` is the exact softmax; ``"flash"`` runs
``ops.flash_attention`` (the CUDA kernels K4, K5 and K6 on a card, their
plain versions on the CPU; the JAX package's ``"flash_interpret"`` has
no counterpart). With ``binarized_attention=False`` the q/k/v/out
projections are fp32 ``nn.Linear``s (the JAX package's
partial-binarization ablation).

The MLP's activation is ``layers.hard_tanh``, flax's ``nn.hard_tanh``:
it passes the gradient at exactly +-1, where ``F.hardtanh``'s is 0.

The token embedding is looked up by ``embed``, whose weight gradient is
a one-hot matrix product: PyTorch's own embedding backward on a CUDA
device is not bitwise equal from run to run, and the JAX package's
training is.

LayerNorm is flax's ``nn.LayerNorm`` written out (``layer_norm``):
epsilon 1e-6 (PyTorch's default is 1e-5) and the fast variance
``max(0, mean(x^2) - mean(x)^2)``, applied as
``(x - mean) * (rsqrt(var + eps) * scale) + bias``. The parameter names
(``ln_*.weight``, ``ln_*.bias``) map to flax's ``scale``/``bias`` in
``interop.lm_params_from_jax``.

Parameters are made on the CPU from the given ``torch.Generator``; move
the module with ``.to(device)``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.binarize import STEMode
from ..ops.flash_attention import flash_attention
from .layers import BinarizedDense, Dropout, SeededTrainRNG, hard_tanh

LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last axis, in its order of
    operations (``normalization._compute_stats`` and ``_normalize``)."""
    mean = x.mean(dim=-1, keepdim=True)
    mean2 = (x * x).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale
    return (x - mean) * mul + bias


class LayerNorm(nn.Module):
    """flax-convention LayerNorm with parameters ``weight`` (flax
    ``scale``) and ``bias``."""

    def __init__(self, features: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def embed_weight_grad(tokens: torch.Tensor, g: torch.Tensor,
                      vocab: int) -> torch.Tensor:
    """The gradient of ``weight[tokens]`` with respect to a (vocab, E)
    ``weight``, from the output's gradient ``g``: ``one_hot(tokens)^T @
    g``, one fp32 matrix product."""
    ids = torch.arange(vocab, device=tokens.device)
    onehot = (tokens.reshape(-1, 1) == ids).to(g.dtype)
    return onehot.t() @ g.reshape(-1, g.shape[-1])


class _Embed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, weight):
        ctx.save_for_backward(tokens)
        ctx.vocab = weight.shape[0]
        return nn.functional.embedding(tokens, weight)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        return None, embed_weight_grad(tokens, g, ctx.vocab)


def embed(tokens: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``weight[tokens]``, as ``nn.functional.embedding``, with the weight
    gradient of ``embed_weight_grad``: bitwise equal from run to run on a
    card, where the lookup's own backward is not."""
    return _Embed.apply(tokens, weight)


def _attend_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = False) -> torch.Tensor:
    """Exact (B, T, H, D) softmax attention."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        t = scores.shape[-1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


ATTENTIONS = ("xla", "flash")


def _check_attention(attention: str) -> None:
    if attention not in ATTENTIONS:
        raise ValueError(
            f"unknown attention {attention!r} (have: {', '.join(ATTENTIONS)})"
        )


def _fp32_linear(fan_in: int, fan_out: int,
                 generator: Optional[torch.Generator]) -> nn.Linear:
    """nn.Linear with flax Dense's init: LeCun-normal kernel, zero bias."""
    lin = nn.Linear(fan_in, fan_out)
    with torch.no_grad():
        lin.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        lin.bias.zero_()
    return lin


class BinarizedSelfAttention(nn.Module):
    """Multi-head self-attention with binarized q/k/v/out projections
    (fp32 ``nn.Linear``s with ``binarized=False``).

    ``attention_fn`` replaces the core with any (q, k, v) -> out callable
    over (B, T, H, D), e.g. ``parallel.make_ring_attention(group,
    causal=True)`` over this rank's sequence shard; it owns its masking.
    The projections are per token, so the ring carries all of sequence
    parallelism's traffic."""

    def __init__(
        self, embed_dim: int, num_heads: int, *, attention: str = "xla",
        causal: bool = False, ste: STEMode = "identity", scale: bool = False,
        backend: str = "bf16", binarized: bool = True,
        attention_fn: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} not divisible by num_heads "
                f"{num_heads}"
            )
        _check_attention(attention)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.attention = attention
        self.attention_fn = attention_fn
        self.causal = causal

        def dense():
            if not binarized:
                return _fp32_linear(embed_dim, embed_dim, generator)
            return BinarizedDense(embed_dim, embed_dim, ste=ste, scale=scale,
                                  backend=backend, generator=generator)

        self.q, self.k, self.v, self.out = dense(), dense(), dense(), dense()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the heads are the projections' width over the head dim: all of
        # them, or this rank's under tensor parallelism (column-parallel
        # q/k/v, parallel.model_parallel)
        b, t, _ = x.shape
        d = self.embed_dim // self.num_heads
        q = self.q(x).reshape(b, t, -1, d)
        k = self.k(x).reshape(b, t, -1, d)
        v = self.v(x).reshape(b, t, -1, d)
        if self.attention_fn is not None:
            core = self.attention_fn(q, k, v)
        elif self.attention == "flash":
            core = flash_attention(q, k, v, causal=self.causal)
        else:
            core = _attend_xla(q, k, v, causal=self.causal)
        return self.out(core.reshape(b, t, -1))


class TransformerBlock(nn.Module):
    """Pre-norm block: x += attn(LN(x)); x += mlp(LN(x)), the MLP as
    BinarizedDense -> hard_tanh -> BinarizedDense (fp32 ``nn.Linear``s
    with ``binarized=False``, the fp32 twin). Dropout, where set, acts in
    training mode only, drawing from the generator ``forward`` is given
    (flax's ``nn.Dropout``, ``layers.Dropout``)."""

    def __init__(
        self, embed_dim: int, num_heads: int, *, mlp_ratio: int = 2,
        dropout: float = 0.0, attention: str = "xla", causal: bool = False,
        ste: STEMode = "identity", scale: bool = False,
        backend: str = "bf16", binarized_attention: bool = True,
        binarized: bool = True, attention_fn: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        hidden = embed_dim * mlp_ratio
        self.binarized = binarized
        self.ln_attn = LayerNorm(embed_dim)
        self.attn = BinarizedSelfAttention(
            embed_dim, num_heads, attention=attention, causal=causal,
            ste=ste, scale=scale, backend=backend,
            binarized=binarized_attention, attention_fn=attention_fn,
            generator=generator,
        )
        self.ln_mlp = LayerNorm(embed_dim)

        def dense(i, o):
            if not binarized:
                return _fp32_linear(i, o, generator)
            return BinarizedDense(i, o, ste=ste, scale=scale,
                                  backend=backend, generator=generator)

        self.mlp1 = dense(embed_dim, hidden)
        self.mlp2 = dense(hidden, embed_dim)
        self.drop = Dropout(dropout)

    def flax_names(self, prefix: str = "", sub: str = ""):
        """(submodule, flax module, kind) of the block's layers, under
        ``sub`` and the flax path ``prefix``."""
        attn = ("BinarizedDense" if isinstance(self.attn.q, BinarizedDense)
                else "Dense")
        mlp = "BinarizedDense" if self.binarized else "Dense"
        return ([(f"{sub}ln_attn", f"{prefix}ln_attn", "ln"),
                 (f"{sub}ln_mlp", f"{prefix}ln_mlp", "ln")]
                + [(f"{sub}attn.{n}",
                    f"{prefix}BinarizedSelfAttention_0/{attn}_{j}", "dense")
                   for j, n in enumerate(("q", "k", "v", "out"))]
                + [(f"{sub}mlp1", f"{prefix}{mlp}_0", "dense"),
                   (f"{sub}mlp2", f"{prefix}{mlp}_1", "dense")])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.drop(self.attn(self.ln_attn(x)), generator)
        y = hard_tanh(self.mlp1(self.ln_mlp(x)))
        return x + self.drop(self.mlp2(y), generator)


class BinarizedLM(SeededTrainRNG, nn.Module):
    """Causal binarized language model: fp32 token and position
    embeddings, ``depth`` pre-norm causal blocks, fp32 LN and head over
    the vocabulary. ``forward(tokens (B, T))`` returns (B, T, vocab)
    next-token log-probs (position t predicts token t + 1). In train
    mode the blocks' dropout draws from ``train_generator``, seeded with
    ``rng_seed``: two LMs of one seed drop the same units."""

    def __init__(
        self, vocab: int = 256, max_len: int = 256, embed_dim: int = 128,
        depth: int = 2, num_heads: int = 4, mlp_ratio: int = 2,
        dropout: float = 0.0, attention: str = "xla",
        ste: STEMode = "identity", scale: bool = False,
        backend: str = "bf16", binarized_attention: bool = True,
        attention_fn: Optional[Callable] = None,
        rng_seed: int = 0, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        _check_attention(attention)
        self.rng_seed = rng_seed
        self.vocab = vocab
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.scale = scale
        self.tok_embed = nn.Embedding(vocab, embed_dim)
        self.pos_embed = nn.Parameter(torch.empty(1, max_len, embed_dim))
        with torch.no_grad():
            # flax nn.Embed's default (variance scaling, fan-in normal)
            # and the JAX model's normal(0.02) position embedding
            self.tok_embed.weight.normal_(0.0, embed_dim ** -0.5,
                                          generator=generator)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                embed_dim, num_heads, mlp_ratio=mlp_ratio, dropout=dropout,
                attention=attention, causal=True, ste=ste, scale=scale,
                backend=backend, binarized_attention=binarized_attention,
                attention_fn=attention_fn, generator=generator,
            )
            for _ in range(depth)
        )
        self.ln_head = LayerNorm(embed_dim)
        self.head = _fp32_linear(embed_dim, vocab, generator)

    def flax_names(self):
        """(submodule, flax module path, kind) of every parametrised
        layer (``interop``)."""
        out = [("tok_embed", "tok_embed", "embed"),
               ("pos_embed", "pos_embed", "param")]
        for i, blk in enumerate(self.blocks):
            out += blk.flax_names(f"TransformerBlock_{i}/", f"blocks.{i}.")
        return out + [("ln_head", "ln_head", "ln"), ("head", "head", "dense")]

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """The blocks' input: token plus position embeddings."""
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} > max_len {self.max_len}")
        return embed(tokens, self.tok_embed.weight) + self.pos_embed[:, :t]

    def head_out(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks' output to next-token log-probs."""
        return torch.log_softmax(self.head(self.ln_head(x)), dim=-1)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed_tokens(tokens)
        gen = self.train_generator(x.device) if self.training else None
        for blk in self.blocks:
            x = blk(x, gen)
        return self.head_out(x)


class BinarizedTransformer(SeededTrainRNG, nn.Module):
    """Patch-embedding binarized transformer classifier (the JAX
    ``BinarizedTransformer``, the ViT family): (B, H, W, C) images (or
    (B, 784) flat 28 x 28 ones) cut into ``patch_size`` patches in
    flax's (row, col, (py, px, c)) order, a patch embedding on raw pixels
    (binarized weights, fp32 input: the reference's first layer), a
    learned ``pos_embed``, ``depth`` pre-norm blocks, ``ln_head``, the
    mean over tokens and the fp32 head, log-softmax. ``binarized=False``
    is the fp32 twin (every projection an ``nn.Linear``);
    ``binarized_attention=False`` the partial-binarization ablation. In
    train mode the blocks' dropout draws from ``train_generator``."""

    def __init__(
        self, num_classes: int = 10, patch_size: int = 7,
        embed_dim: int = 128, depth: int = 2, num_heads: int = 4,
        mlp_ratio: int = 2, dropout: float = 0.0, attention: str = "xla",
        ste: STEMode = "identity", scale: bool = False,
        backend: str = "bf16", binarized: bool = True,
        binarized_attention: Optional[bool] = None,
        image_size: int = 28, in_channels: int = 1,
        attention_fn: Optional[Callable] = None, rng_seed: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        _check_attention(attention)
        if image_size % patch_size:
            raise ValueError(f"input {image_size}x{image_size} not "
                             f"divisible by patch_size {patch_size}")
        self.rng_seed = rng_seed
        self.num_classes = num_classes
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.scale = scale
        self.binarized = binarized
        self.image_size = image_size
        self.in_channels = in_channels
        tokens = (image_size // patch_size) ** 2
        fan_in = patch_size * patch_size * in_channels
        if binarized:
            self.patch_embed = BinarizedDense(
                fan_in, embed_dim, binarize_input=False, ste=ste,
                backend=backend, generator=generator)
        else:
            self.patch_embed = _fp32_linear(fan_in, embed_dim, generator)
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, embed_dim))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        attn_bin = binarized if binarized_attention is None else (
            binarized_attention)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                embed_dim, num_heads, mlp_ratio=mlp_ratio, dropout=dropout,
                attention=attention, ste=ste, scale=scale, backend=backend,
                binarized_attention=attn_bin, binarized=binarized,
                attention_fn=attention_fn, generator=generator,
            )
            for _ in range(depth)
        )
        self.ln_head = LayerNorm(embed_dim)
        self.head = _fp32_linear(embed_dim, num_classes, generator)

    def flax_names(self):
        """(submodule, flax module path, kind) of every parametrised
        layer (``interop``): the patch embedding is flax's auto-named
        ``BinarizedDense_0`` (``Dense_0`` in the fp32 twin)."""
        out = [("patch_embed",
                "BinarizedDense_0" if self.binarized else "Dense_0",
                "dense"),
               ("pos_embed", "pos_embed", "param")]
        for i, blk in enumerate(self.blocks):
            out += blk.flax_names(f"TransformerBlock_{i}/", f"blocks.{i}.")
        return out + [("ln_head", "ln_head", "ln"), ("head", "head", "dense")]

    def patches(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) or (B, H*W) images -> (B, T, p*p*C) patches."""
        if x.dim() == 2:
            x = x.reshape(x.shape[0], self.image_size, self.image_size,
                          self.in_channels)
        b, h, w, c = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch_size {p}")
        nh, nw = h // p, w // p
        x = x.reshape(b, nh, p, nw, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, nh * nw, p * p * c)

    def embed_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks' input: embedded patches plus ``pos_embed``."""
        return self.patch_embed(self.patches(x)) + self.pos_embed

    def head_out(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks' output to class log-probs (mean over tokens)."""
        x = self.ln_head(x).mean(dim=1)
        return torch.log_softmax(self.head(x), dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.embed_tokens(x)
        gen = self.train_generator(h.device) if self.training else None
        for blk in self.blocks:
            h = blk(h, gen)
        return self.head_out(h)


def bnn_vit_tiny(**kw) -> BinarizedTransformer:
    """MNIST-sized: 7x7 patches -> 16 tokens, 128-dim, 2 blocks."""
    kw.setdefault("patch_size", 7)
    kw.setdefault("embed_dim", 128)
    kw.setdefault("depth", 2)
    kw.setdefault("num_heads", 4)
    return BinarizedTransformer(**kw)


def bnn_vit_small(**kw) -> BinarizedTransformer:
    """CIFAR-sized: 4x4 patches -> 64 tokens, 256-dim, 4 blocks (the
    input image size follows ``image_size``, 28 by default, as the
    trainer feeds MNIST)."""
    kw.setdefault("patch_size", 4)
    kw.setdefault("embed_dim", 256)
    kw.setdefault("depth", 4)
    kw.setdefault("num_heads", 8)
    return BinarizedTransformer(**kw)


def fp32_vit_tiny(**kw) -> BinarizedTransformer:
    """bnn-vit-tiny with binarization removed (the fp32 twin)."""
    kw.setdefault("binarized", False)
    return bnn_vit_tiny(**kw)


def fp32_vit_small(**kw) -> BinarizedTransformer:
    """bnn-vit-small with binarization removed (the fp32 twin)."""
    kw.setdefault("binarized", False)
    return bnn_vit_small(**kw)


def lm_loss(log_probs: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy: position t's log-probs score token t+1
    (the final position has no target and is dropped)."""
    targets = tokens[:, 1:].long()
    lp = log_probs[:, :-1]
    return -lp.gather(-1, targets[..., None]).mean()
