"""Time K1-K3 (the packed ±1 GEMMs) and the paths that run them, for one
tree of this repo on a CUDA card, so two trees can be compared in one run.

    python scripts/torch_xnor_timing.py [--root DIR] [--label NAME]

``--root`` is a checkout of this repository (default: the one holding
this script); its ``distributed_mnist_bnns_tpu_torch`` and its
``chip_smoke.py`` helpers are imported from there, and its kernels are
built there. To compare a change with its parent on one card, unpack the
parent with ``git archive`` into an ignored directory and run, in one
command, parent, change, change, parent.

Prints one JSON line per measurement, each with the label and the card's
name and power limit:

  * K1 at the LM's decode projection (M, K, N) = (4, 256, 512) and at M =
    1, 16 and 64, K2 at the MLP's layer 2 (32, 3072, 1536) and at M = 256,
    K3 at its layer 3 (32, 1536, 768): the kernel alone (``kernel_ms``; a
    tree whose kernel takes packed x is given ``pack_bits(x)``), the public
    entry from ±1 fp32 x (``entry_ms``), and for K1 the LM decoder's entry
    from raw x (``lm_entry_ms``: the binarizing entry, or ``binarize_ste``
    then the public entry where the tree has none), each the CUDA-graph
    median device time of one call, as ``chip_smoke.py`` times kernels;
  * the paged decoder of the ``bench.py --lm-serve-bench`` LM (seeded
    weights): one decode iteration (4 slots at position 100) and one
    prefill chunk (16 tokens at 96), device time and kernel launches from
    ``torch.profiler``, and the decode iteration's host-clock time;
  * the frozen ``bnn-mlp-large`` predictor (seeded weights, batch 32):
    device time, kernel launches and host-clock time of one batch.

Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (kernel, M, K, N): the main paths' shapes and the rows beside them
SHAPES = [("xnor", m, 256, 512) for m in (4, 1, 16, 64)]
SHAPES += [("xnor_sign", m, 3072, 1536) for m in (32, 256)]
SHAPES += [("xnor_affine", 32, 1536, 768)]


def host_ms(fn, calls: int = 30) -> float:
    """Median host-clock time of one ``fn()`` ending in a synchronise."""
    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_xnor_timing: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_frozen,
        load_packed,
    )
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        make_paged_lm_decoder,
    )
    from distributed_mnist_bnns_tpu_torch.models import BinarizedLM, get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.binarize import binarize_ste
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    if not os.path.abspath(cs.__file__).startswith(root + os.sep):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    tag = {"label": args.label, "card": smi}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    _kernels.build(["paged_attn.cu", "xnor_gemm.cu", "xnor_unpack.cu"])
    packs_inside = hasattr(_kernels, "PACK_GT0")
    binarize_entry = getattr(xg, "_xnor_matmul_binarize", None)

    gen = torch.Generator().manual_seed(0)
    entries = {"xnor": xg.xnor_matmul_packed,
               "xnor_sign": xg.xnor_matmul_packed_sign,
               "xnor_affine": xg.xnor_matmul_packed_affine}
    for name, m, k, n in SHAPES:
        wp, _, _ = xg.prepack_weights(cs._pm1(gen, k, n).to(device))
        x = cs._pm1(gen, m, k).to(device)
        xr = torch.randn(m, k, generator=gen).to(device)
        vecs = () if name == "xnor" else tuple(
            v.to(device) for v in cs._affine_vectors(gen, n))
        xk = x if packs_inside else pack_bits(x)
        entry = entries[name]
        row = {**tag, "kernel": name, "m": m, "k": k, "n": n,
               "kernel_ms": cs._graph_ms(
                   lambda: _kernels.xnor_gemm(name, xk, wp, k, n, *vecs)),
               "entry_ms": cs._graph_ms(lambda: entry(x, wp, k, n, *vecs))}
        if name == "xnor":
            if binarize_entry is None:
                row["lm_entry_ms"] = cs._graph_ms(lambda: entry(
                    binarize_ste(xr), wp, k, n))
            else:
                row["lm_entry_ms"] = cs._graph_ms(
                    lambda: binarize_entry(xr, wp, k, n))
        print(json.dumps(row), flush=True)

    model = BinarizedLM(**cs.LM_WIDTH, generator=gen).eval()
    cs._random_lm_params(model, gen)
    mlp = get_model("bnn-mlp-large", generator=gen)
    cs._random_bn_stats(mlp, gen)
    mlp.eval()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm.msgpack")
        export_packed(model, path)
        frozen = load_frozen(path)
        mlp_path = os.path.join(tmp, "mlp.msgpack")
        export_packed(mlp, mlp_path)
        predict, _ = load_packed(mlp_path, device=device)
    dec = make_paged_lm_decoder(frozen, slots=cs.LM_SLOTS,
                                page_size=cs.LM_PAGE,
                                prefill_chunk=cs.LM_CHUNK, device=device)
    pools = dec.init_pools()
    tables = np.zeros((dec.slots, dec.max_pages), np.int32)
    tables[:, :8] = np.arange(1, 1 + 8 * dec.slots).reshape(dec.slots, 8)
    toks = np.arange(dec.slots, dtype=np.int32)
    poss = np.full(dec.slots, 100, np.int32)
    decode = lambda: dec.decode(pools, toks, tables, poss)  # noqa: E731
    decode_ms, decode_top, decode_kernels = cs._profile_device_ms(decode)
    chunk = np.arange(cs.LM_CHUNK, dtype=np.int32)
    prefill_ms, prefill_top, prefill_kernels = cs._profile_device_ms(
        lambda: dec.prefill(pools, chunk, tables[0], 96, 112))
    print(json.dumps({**tag, "decode_device_ms": decode_ms,
                      "decode_kernels_per_iteration": decode_kernels,
                      "decode_host_ms": host_ms(decode),
                      "decode_top_device_ms": decode_top,
                      "prefill_chunk_device_ms": prefill_ms,
                      "prefill_kernels_per_chunk": prefill_kernels,
                      "prefill_top_device_ms": prefill_top}), flush=True)

    images = (torch.randint(0, 256, (cs.MAIN_M, 28, 28, 1), generator=gen)
              / 256.0).to(device)
    batch = lambda: predict(images)  # noqa: E731
    mlp_ms, mlp_top, mlp_kernels = cs._profile_device_ms(batch)
    print(json.dumps({**tag, "predict_device_ms_batch": mlp_ms,
                      "predict_kernels_per_batch": mlp_kernels,
                      "predict_host_ms_batch": host_ms(batch),
                      "predict_top_device_ms": mlp_top}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
