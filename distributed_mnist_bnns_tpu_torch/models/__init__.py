from .bnn_cnn import BinarizedCNN
from .cnn import DeepCNN
from .convnet import ConvNet
from .layers import BatchNorm, BinarizedConv, BinarizedDense, QuantizedDense
from .mlp import (
    BnnMLP,
    QnnMLP,
    bnn_mlp_large,
    bnn_mlp_small,
    fp32_mlp_large,
    qnn_mlp_large,
)
from .moe import BinarizedExperts, BnnMoEMLP, bnn_moe_mlp
from .registry import get_model, latent_clamp_mask, list_models
from .resnet import (
    XnorBasicBlock,
    XnorBottleneckBlock,
    XnorResNet,
    fp32_resnet18,
    xnor_resnet18,
    xnor_resnet50,
)
from .transformer import (
    BinarizedLM,
    BinarizedTransformer,
    bnn_vit_small,
    bnn_vit_tiny,
    fp32_vit_small,
    fp32_vit_tiny,
    lm_loss,
)

__all__ = [
    "BatchNorm",
    "BinarizedCNN",
    "BinarizedConv",
    "BinarizedDense",
    "BinarizedExperts",
    "BinarizedLM",
    "BinarizedTransformer",
    "BnnMLP",
    "BnnMoEMLP",
    "ConvNet",
    "DeepCNN",
    "QnnMLP",
    "QuantizedDense",
    "XnorBasicBlock",
    "XnorBottleneckBlock",
    "XnorResNet",
    "bnn_mlp_large",
    "bnn_mlp_small",
    "bnn_moe_mlp",
    "bnn_vit_small",
    "bnn_vit_tiny",
    "fp32_mlp_large",
    "fp32_resnet18",
    "fp32_vit_small",
    "fp32_vit_tiny",
    "get_model",
    "latent_clamp_mask",
    "list_models",
    "lm_loss",
    "qnn_mlp_large",
    "xnor_resnet18",
    "xnor_resnet50",
]
