"""Model registry: the names the CLI accepts, as in the JAX package's
``models/registry.py`` (the bnn-mlp family, its fp32 twin and the conv
families, so far), and ``latent_clamp_mask``."""

from __future__ import annotations

from typing import Any, Callable, Dict

from torch import nn

from .bnn_cnn import BinarizedCNN
from .cnn import DeepCNN
from .convnet import ConvNet
from .layers import BinarizedConv, BinarizedDense
from .mlp import bnn_mlp_large, bnn_mlp_small, fp32_mlp_large

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    # flagship BNN MLPs (mnist-dist2.py:46-76 / mnist-dist3.py:40-70)
    "bnn-mlp-large": bnn_mlp_large,
    "bnn-mlp-small": bnn_mlp_small,
    # the flagship's fp32 twin
    "fp32-mlp-large": fp32_mlp_large,
    # fp32 baselines (mnist-dist.py:31-51, mnist-cnn server.py:7-52)
    "convnet": ConvNet,
    "deep-cnn": DeepCNN,
    # the binarized CNN (BASELINE.json; BinarizeConv2d)
    "bnn-cnn": BinarizedCNN,
}


def list_models():
    return sorted(_REGISTRY)


def get_model(name: str, **kwargs: Any) -> nn.Module:
    """The model ``name``; ``kwargs`` (``infl_ratio``, ``backend``,
    ``ste``, ``stochastic``, ``dropout_rate``, ``dtype``, ``rng_seed``,
    ``generator``, as the model takes them) go to its constructor."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {list_models()}")
    return _REGISTRY[name](**kwargs)


def latent_clamp_mask(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The latent parameters that training clamps to [-1, 1]: those whose
    immediate owner is a ``BinarizedDense`` or a ``BinarizedConv``, its
    weight and its bias, by qualified name. The JAX package's rule
    (registry.py:75-98) selects the same set from the flax tree.
    Embeddings, BatchNorm, LayerNorm, the head, fp32 convs and the fp32
    ``nn.Linear`` projections of ``binarized_attention=False`` stay
    out."""
    return {
        f"{owner}.{name}" if owner else name: p
        for owner, mod in model.named_modules()
        if isinstance(mod, (BinarizedDense, BinarizedConv))
        for name, p in mod.named_parameters(recurse=False)
    }
