"""Time the port's sequence-parallel ring attention over the cards of one
host.

    python3 scripts/torch_ring_timing.py [--steps N]

One NCCL rank a card. Each rank holds its shard of the sequence
(``parallel.make_ring_attention`` over the default group) and times, over
``--steps`` calls after 3 untimed ones:

  attn-L   the ring's forward and backward (the flash local step: K4, K5
           and K6 on the card; and the dense one), causal, at batch 8, 4
           heads, head dim 64 and a whole sequence L of 1,024 and 4,096
  lm       one ``lm_demo.ring_train_step`` of the LM at the ``--lm-bench``
           width (vocab 256, embed 256, depth 4, 4 heads, 8 x 1,024
           tokens, Adam 1e-3), and rank 0 the plain ``train_step`` of the
           same model on its own card

Each time is the host clock over the timed calls, synchronised at their
end (``torch.cuda.synchronize``): the ring's exchanges and waits are in
it. One JSON line a run and rank, then the cards' name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WARMUP = 3
SOURCES = ["flash_attn.cu", "flash_bwd.cu", "xnor_gemm.cu"]
B, H, D = 8, 4, 64
LENGTHS = (1024, 4096)
LM = dict(vocab=256, embed_dim=256, depth=4, num_heads=4, mlp_ratio=2)
LM_SEQ, LM_BATCH, LM_LR = 1024, 8, 1e-3


def _timed(fn, steps: int) -> float:
    """Milliseconds a call: ``steps`` calls after ``WARMUP``, host clock,
    synchronised at the end."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def _attn_runs(rank, world, device, steps) -> list:
    from distributed_mnist_bnns_tpu_torch.parallel import make_ring_attention

    gen = torch.Generator().manual_seed(0)
    rows = []
    for length in LENGTHS:
        ll = length // world
        q, k, v, g = (torch.randn(B, length, H, D, generator=gen)[
            :, rank * ll:(rank + 1) * ll].contiguous().to(device)
            for _ in range(4))
        for local in ("flash", "dense"):
            ring = make_ring_attention(causal=True, local=local)
            shards = [t.clone().requires_grad_() for t in (q, k, v)]

            def step():
                out = ring(*shards)
                out.backward(g)

            rows.append({"run": f"attn-{length}", "local": local,
                         "rank": rank, "world": world, "shard": ll,
                         "fwd_bwd_ms": _timed(step, steps),
                         "peak_mb": torch.cuda.max_memory_allocated()
                         / 2 ** 20})
    return rows


def _lm_runs(rank, world, device, steps) -> list:
    from distributed_mnist_bnns_tpu_torch.examples import lm_demo
    from distributed_mnist_bnns_tpu_torch.models import (
        BinarizedLM,
        latent_clamp_mask,
    )
    from distributed_mnist_bnns_tpu_torch.parallel import make_ring_attention

    _, draw = lm_demo.token_stream(LM_SEQ, LM_BATCH, LM["vocab"], seed=0)
    toks = torch.from_numpy(draw()).to(device)
    rows = []
    kinds = [("ring", make_ring_attention(causal=True))]
    if rank == 0:
        kinds.append(("plain", None))
    for kind, attn in kinds:
        torch.cuda.reset_peak_memory_stats()
        model = BinarizedLM(**LM, max_len=LM_SEQ, attention_fn=attn,
                            attention="flash",
                            generator=torch.Generator().manual_seed(0)
                            ).to(device)
        opt = lm_demo.make_optimizer(model, LM_LR)
        latents = list(latent_clamp_mask(model).values())
        if kind == "ring":
            step = lambda: lm_demo.ring_train_step(model, opt, latents, toks)
        else:
            step = lambda: lm_demo.train_step(model, opt, latents, toks)
        rows.append({"run": f"lm-{kind}", "rank": rank, "world": world,
                     "step_ms": _timed(step, steps),
                     "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20})
    return rows


def _rank(rank: int, world: int, device, steps: int) -> list:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _attn_runs(rank, world, device, steps) + _lm_runs(
        rank, world, device, steps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ring_timing: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.parallel import spawn

    _kernels.build(sources=SOURCES)
    world = torch.cuda.device_count()
    for rows in spawn(_rank, world, backend="nccl", device="cuda",
                      args=(args.steps,)):
        for row in rows:
            print(json.dumps(row), flush=True)
    for line in smi:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
