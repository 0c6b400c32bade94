"""Check that the port's fp32 convs stay fp32 in a fresh process.

    python3 scripts/torch_conv_fp32_check.py [--device cuda]

Runs ``cli train --model convnet`` (one epoch of a small synthetic
split, ``--precision fp32``) in this process, which sets no TF32 or
cuDNN flag itself (PyTorch's default ``cudnn.allow_tf32`` is True), and
keeps the first forward call of each conv (its input, weight, bias and
output). Each output is held to a float64 conv of the same inputs: the
error of every output, over the sum of |x| |w| |b| of its terms, must
stay within K * 2^-24 (K = cin * kh * kw + 1 terms), the bound of an fp32
sum. A TF32 conv rounds its inputs to 10 mantissa bits, about 2^-11 of
that sum; the same conv run with TF32 allowed and outside the port's
scope is printed beside it for scale. Prints one JSON line; exits 1 if
a conv misses the bound.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ratio(out, x, w, b, padding):
    """max |out - conv64| / conv(|x|, |w|) + |b| over the outputs."""
    f = torch.nn.functional
    pad = (padding, padding) if isinstance(padding, int) else padding
    x64, w64, b64 = x.double(), w.double(), b.double()
    want = f.conv2d(x64, w64, b64, 1, pad)
    scale = f.conv2d(x64.abs(), w64.abs(), b64.abs(), 1, pad)
    return float(((out.double() - want).abs() / scale.clamp_min(1e-30))
                 .max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from distributed_mnist_bnns_tpu_torch import cli
    from distributed_mnist_bnns_tpu_torch.models.layers import Conv

    default_tf32 = torch.backends.cudnn.allow_tf32
    seen = []

    def keep(mod, inputs, out):
        if isinstance(mod, Conv) and len(seen) < 2:
            seen.append((inputs[0].detach().clone(),
                         mod.weight.detach().clone(),
                         mod.bias.detach().clone(), out.detach().clone(),
                         mod.padding))

    handle = torch.nn.modules.module.register_module_forward_hook(keep)
    rc = cli.main(["--log-level", "WARNING", "train", "--model", "convnet",
                   "--epochs", "1", "--batch-size", "64",
                   "--synthetic-sizes", "640", "128",
                   "--device", args.device])
    handle.remove()
    rows = []
    ok = rc == 0 and len(seen) == 2
    for i, (x, w, b, out, padding) in enumerate(seen):
        k = w[0].numel() + 1
        bound = k * 2.0 ** -24
        ratio = _ratio(out, x, w, b, padding)
        # the same conv with TF32 allowed, outside the port's scope
        torch.backends.cudnn.allow_tf32 = True
        tf32 = torch.nn.functional.conv2d(x, w, b, 1, padding)
        torch.backends.cudnn.allow_tf32 = default_tf32
        rows.append({"conv": i + 1, "k": k, "err_over_sum": ratio,
                     "bound": bound, "tf32_err_over_sum":
                     _ratio(tf32, x, w, b, padding)})
        ok = ok and ratio <= bound
    print(json.dumps({"conv_fp32_check": rows, "ok": ok,
                      "default_cudnn_allow_tf32": default_tf32,
                      "cudnn_allow_tf32_after":
                          torch.backends.cudnn.allow_tf32,
                      "device": args.device}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
