from .bnn_cnn import BinarizedCNN
from .cnn import DeepCNN
from .convnet import ConvNet
from .layers import BatchNorm, BinarizedConv, BinarizedDense
from .mlp import BnnMLP, bnn_mlp_large, bnn_mlp_small, fp32_mlp_large
from .registry import get_model, latent_clamp_mask, list_models
from .transformer import BinarizedLM, lm_loss

__all__ = [
    "BatchNorm",
    "BinarizedCNN",
    "BinarizedConv",
    "BinarizedDense",
    "BinarizedLM",
    "BnnMLP",
    "ConvNet",
    "DeepCNN",
    "bnn_mlp_large",
    "bnn_mlp_small",
    "fp32_mlp_large",
    "get_model",
    "latent_clamp_mask",
    "list_models",
    "lm_loss",
]
