"""Model registry: the names the CLI accepts, as in the JAX package's
``models/registry.py`` (the bnn-mlp family only, so far)."""

from __future__ import annotations

from typing import Any, Callable, Dict

from torch import nn

from .mlp import bnn_mlp_large, bnn_mlp_small

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "bnn-mlp-large": bnn_mlp_large,
    "bnn-mlp-small": bnn_mlp_small,
}


def list_models():
    return sorted(_REGISTRY)


def get_model(name: str, **kwargs: Any) -> nn.Module:
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {list_models()}")
    return _REGISTRY[name](**kwargs)
