from .layers import BinarizedDense
from .mlp import BnnMLP, bnn_mlp_large, bnn_mlp_small
from .registry import get_model, list_models

__all__ = [
    "BinarizedDense",
    "BnnMLP",
    "bnn_mlp_large",
    "bnn_mlp_small",
    "get_model",
    "list_models",
]
