"""Model registry: the names the CLI accepts, as in the JAX package's
``models/registry.py`` (the bnn-mlp family only, so far), and
``latent_clamp_mask``."""

from __future__ import annotations

from typing import Any, Callable, Dict

from torch import nn

from .layers import BinarizedDense
from .mlp import bnn_mlp_large, bnn_mlp_small

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "bnn-mlp-large": bnn_mlp_large,
    "bnn-mlp-small": bnn_mlp_small,
}


def list_models():
    return sorted(_REGISTRY)


def get_model(name: str, **kwargs: Any) -> nn.Module:
    """The model ``name``; ``kwargs`` (``infl_ratio``, ``backend``,
    ``ste``, ``stochastic``, ``dropout_rate``, ``rng_seed``,
    ``generator``) go to its constructor."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {list_models()}")
    return _REGISTRY[name](**kwargs)


def latent_clamp_mask(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The latent parameters that training clamps to [-1, 1]: those whose
    immediate owner is a ``BinarizedDense``, its weight and its bias, by
    qualified name. The JAX package's rule (registry.py:75-98) selects
    the same set from the flax tree. Embeddings, LayerNorm, the head and
    the fp32 ``nn.Linear`` projections of ``binarized_attention=False``
    stay out."""
    return {
        f"{owner}.{name}" if owner else name: p
        for owner, mod in model.named_modules()
        if isinstance(mod, BinarizedDense)
        for name, p in mod.named_parameters(recurse=False)
    }
