"""distributed_mnist_bnns_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (``distributed_mnist_bnns_tpu``),
which stays the reference the port is held against. This package imports
torch and numpy, never JAX nor the JAX package. Its packed ±1 GEMMs run
as hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc``
at first use; on CPU tensors they take their plain PyTorch versions.

So far it covers serving the frozen binarized MLP (``bnn-mlp-large`` /
``bnn-mlp-small``): ops (bitpack, binarize, xnor_gemm), models, interop
with JAX weights, infer (freeze / export / load), data (MNIST), the HTTP
server (serve/) and the CLI (``infer``, ``serve``, ``export``).
"""

__version__ = "0.1.0"
