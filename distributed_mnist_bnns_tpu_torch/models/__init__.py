from .layers import BinarizedDense
from .mlp import BnnMLP, bnn_mlp_large, bnn_mlp_small
from .registry import get_model, latent_clamp_mask, list_models
from .transformer import BinarizedLM, lm_loss

__all__ = [
    "BinarizedDense",
    "BinarizedLM",
    "BnnMLP",
    "bnn_mlp_large",
    "bnn_mlp_small",
    "get_model",
    "latent_clamp_mask",
    "list_models",
    "lm_loss",
]
