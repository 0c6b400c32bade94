"""Time K8 (paged attention) and the paged LM decoder of one tree of this
repo on a CUDA card, so two trees can be compared in one run.

    python scripts/torch_paged_timing.py [--root DIR] [--label NAME] [--ptxas]

``--root`` is a checkout of this repository (default: the one holding
this script); its ``distributed_mnist_bnns_tpu_torch`` and its
``chip_smoke.py`` helpers are imported from there, and its kernels are
built there. To compare a change with its parent on one card, unpack the
parent with ``git archive`` into an ignored directory and run, in one
command, parent, change, change, parent.

Prints one JSON line per measurement, each with the label and the card's
name and power limit:

  * K8 at the LM path's shapes, (S, C, P) = (4, 1, 16) at qpos 255 and
    20, (1, 16, 16) at positions 240-255 and 32-47, (4, 4, 16) at
    252-255: CUDA-graph median device time, as ``chip_smoke.py`` times
    its kernels;
  * the paged decoder of the ``bench.py --lm-serve-bench`` LM (seeded
    weights): device time of one decode iteration (4 slots at position
    100) and of one prefill chunk (16 tokens at 96), from
    ``torch.profiler``, with its largest kernels;
  * with ``--ptxas``, what ``nvcc -Xptxas -v`` says of ``paged_attn.cu``
    (registers, shared memory, spills of each instance).

Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def paged_cases(cs, gen, device):
    """[(call, (q, qpos, k_pool, v_pool, tables)), ...] at the LM path's
    K8 shapes, from the ``chip_smoke`` module ``cs`` of the tree under
    test: pages of 16, P = 16, H = 4, D = 64, every slot's table full."""
    num_pages = cs.LM_SLOTS * 16 + 1
    perm = torch.randperm(num_pages - 1, generator=gen) + 1
    full = perm[:cs.LM_SLOTS * 16].reshape(cs.LM_SLOTS, 16).to(torch.int32)
    shapes = (("decode", [[255]] * cs.LM_SLOTS),
              ("decode", [[20]] * cs.LM_SLOTS),
              ("prefill", [list(range(240, 256))]),
              ("prefill", [list(range(32, 48))]),
              ("verify", [list(range(252, 256))] * cs.LM_SLOTS))
    return [(call, cs._paged_case(gen, device, len(ql), len(ql[0]), ql,
                                  full[:len(ql)], num_pages))
            for call, ql in shapes]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_timing: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_frozen,
    )
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        make_paged_lm_decoder,
    )
    from distributed_mnist_bnns_tpu_torch.models import BinarizedLM
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import paged_kv as pk

    if not os.path.abspath(cs.__file__).startswith(root + os.sep):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    tag = {"label": args.label, "card": smi}
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    _kernels.build(["paged_attn.cu", "xnor_gemm.cu", "xnor_unpack.cu"])
    if args.ptxas:
        proc = subprocess.run(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.devnull, os.path.join(_kernels.CSRC_DIR, "paged_attn.cu")],
            capture_output=True, text=True)
        lines = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print(json.dumps({**tag, "ptxas": lines}), flush=True)

    gen = torch.Generator().manual_seed(0)
    for what, (q, qpos, kp, vp, tb) in paged_cases(cs, gen, device):
        got = _kernels.paged_attn(q, qpos, kp, vp, tb)
        err = (got - pk.paged_attn_plain(q, qpos, kp, vp, tb)).abs().max()
        print(json.dumps({
            **tag, "kernel": "paged_attn", "call": what, "s": q.shape[0],
            "c": q.shape[1], "p": tb.shape[1],
            "qpos": [qpos[0, 0].item(), qpos[0, -1].item()],
            "kernel_ms": cs._graph_ms(
                lambda: _kernels.paged_attn(q, qpos, kp, vp, tb)),
            "max_abs_err": err.item(),
        }), flush=True)

    model = BinarizedLM(**cs.LM_WIDTH, generator=gen).eval()
    cs._random_lm_params(model, gen)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm.msgpack")
        export_packed(model, path)
        frozen = load_frozen(path)
    dec = make_paged_lm_decoder(frozen, slots=cs.LM_SLOTS,
                                page_size=cs.LM_PAGE,
                                prefill_chunk=cs.LM_CHUNK, device=device)
    pools = dec.init_pools()
    tables = np.zeros((dec.slots, dec.max_pages), np.int32)
    tables[:, :8] = np.arange(1, 1 + 8 * dec.slots).reshape(dec.slots, 8)
    toks = np.arange(dec.slots, dtype=np.int32)
    poss = np.full(dec.slots, 100, np.int32)
    decode_ms, decode_top, _ = cs._profile_device_ms(
        lambda: dec.decode(pools, toks, tables, poss))
    chunk = np.arange(cs.LM_CHUNK, dtype=np.int32)
    prefill_ms, prefill_top, _ = cs._profile_device_ms(
        lambda: dec.prefill(pools, chunk, tables[0], 96, 112))
    print(json.dumps({**tag, "decode_device_ms": decode_ms,
                      "decode_top_device_ms": decode_top,
                      "prefill_chunk_device_ms": prefill_ms,
                      "prefill_top_device_ms": prefill_top}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
