"""Time the port's data-parallel MLP training on the cards of one host.

    python3 scripts/torch_dp_timing.py [--steps N] [--scan-steps S]
                                       [--dp-mode gspmd fsdp]
    python3 scripts/torch_dp_timing.py --phase9 [--epoch-steps N]
    python3 scripts/torch_dp_timing.py --phase13

By default: one NCCL rank a card (every card of the host), ``bnn-mlp-large``
at ``chip_smoke.py``'s phase 9 recipe (Adam 0.01, global batch 64, dropout
0), ``--steps`` steps (default 100) of each run of the ``--dp-mode``
layouts (default both): under ``gspmd`` uncompressed DP (global-batch
BatchNorm, the gradient all-reduce), the 1-bit exchange with error
feedback (``sign_ef``), the majority vote (``sign``, lr 0.001) and, with
an even number of cards, the two-level exchange over (cards / 2) x 2;
under ``fsdp`` fp32 FSDP (``fsdp``) and the compressed FSDP exchange
(``cfsdp``, ``sign_ef``). With ``--scan-steps S`` (S > 1) every run runs
again with ``scan_steps=S``, its steps captured as CUDA graphs with the
collectives inside, and must end bitwise equal to the eager run. The
whole sequence runs ``--repeat`` times (default 2: the first pass pays
NCCL's setup of each kind of collective and group). Every run must end
with the ranks bitwise equal and each rank's measured wire bytes a step
equal to the plan's; one JSON line per run (step time on the host
clock, examples per second, the exchange's time a step from CUDA events
on the eager runs, bytes, each rank's ``torch.cuda.max_memory_allocated``
and optimizer-state bytes) and the cards' name and power limit. Then one
epoch of ``cli train --dp auto --grad-compress sign_ef`` in a process of
its own (the CLI spawns one NCCL rank a card): it must run over every
card, converge, and move the plan's bytes a step.

``--phase9`` runs ``chip_smoke.py``'s phase 9 alone, its (b) epochs cut to
``--epoch-steps`` steps (0: whole epochs); ``--phase13`` its phase 13.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUNS = {"gspmd": {}, "sign_ef": {"grad_compress": "sign_ef"},
        "sign": {"grad_compress": "sign", "learning_rate": 0.001},
        "hier": {"grad_compress": "sign_ef"},
        "fsdp": {"dp_mode": "fsdp"},
        "cfsdp": {"dp_mode": "fsdp", "grad_compress": "sign_ef"}}
LAYOUT = {"fsdp": "fsdp", "cfsdp": "fsdp"}   # the rest: gspmd


def _rank(rank: int, world: int, device, steps: int, names: list,
          repeat: int, scan_steps: int) -> list:
    import chip_smoke as cs

    passes = []
    with tempfile.TemporaryDirectory() as tmp:
        data = cs._dp_data(tmp, steps)
        for _ in range(repeat):
            out = {}
            for name in names:
                cfg = dict(RUNS[name])
                if name == "hier":
                    cfg["dp_hosts"] = world // 2
                out[name] = cs._dp_run(device, data, **cfg)
                if scan_steps > 1:
                    out[f"{name}/scan"] = cs._dp_run(
                        device, data, scan_steps=scan_steps, **cfg)
            passes.append(out)
    return passes


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--repeat", type=int, default=2)
    p.add_argument("--scan-steps", type=int, default=1)
    p.add_argument("--dp-mode", nargs="+", choices=["gspmd", "fsdp"],
                   default=["gspmd", "fsdp"])
    p.add_argument("--phase9", action="store_true")
    p.add_argument("--phase13", action="store_true")
    p.add_argument("--epoch-steps", type=int, default=300)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_dp_timing: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.parallel import spawn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    if args.phase9:
        from distributed_mnist_bnns_tpu_torch.ops import _kernels

        _kernels.build(sources=["xnor_gemm.cu"])
        cs.DP_EPOCH_STEPS = args.epoch_steps or None
        counts, _ = cs.dp_train_phase(torch.device("cuda", 0),
                                      smi.splitlines()[0])
        print(json.dumps({"phase9_s": time.perf_counter() - t0,
                          "launches": counts}), flush=True)
        return 0
    if args.phase13:
        from distributed_mnist_bnns_tpu_torch.ops import _kernels

        _kernels.build(sources=["xnor_gemm.cu"])
        counts, in_graphs = cs.dp_capture_phase(torch.device("cuda", 0),
                                                smi.splitlines()[0])
        print(json.dumps({"phase13_s": time.perf_counter() - t0,
                          "launches": counts, "in_graphs": in_graphs}),
              flush=True)
        return 0
    world = torch.cuda.device_count()
    names = [n for n in RUNS if LAYOUT.get(n, "gspmd") in args.dp_mode
             and (n != "hier" or (world > 2 and world % 2 == 0))]
    runs = [v for n in names for v in (
        (n, f"{n}/scan") if args.scan_steps > 1 else (n,))]
    res = spawn(_rank, world, backend="nccl", device="cuda",
                args=(args.steps, names, args.repeat, args.scan_steps))
    for i in range(args.repeat):
        for name in runs:
            ranks = [r[i][name] for r in res]
            cs._check_ranks(f"nccl x{world} {name}", ranks)
            if name.endswith("/scan") and (
                    ranks[0]["digest"] != res[0][i][name[:-5]]["digest"]):
                raise AssertionError(f"{name}: the captured run differs "
                                     "from the eager one")
            print(json.dumps({
                "dp_run": f"nccl{world}_{name}", "pass": i, "world": world,
                "card": smi.splitlines()[0],
                "max_memory_allocated_by_rank": [
                    r["max_memory_allocated"] for r in ranks],
                **{k: v for k, v in ranks[0].items()
                   if k not in ("losses", "digest", "launches")}}),
                flush=True)
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.parallel import fsdp_memory_fraction

    with torch.device("meta"):
        model = get_model(cs.MLP_TRAIN["model"])
    print(json.dumps({"wall_s": time.perf_counter() - t0,
                      "fsdp_memory_fraction": fsdp_memory_fraction(
                          model, world)}), flush=True)
    if "gspmd" not in args.dp_mode:
        return 0
    cli = cs._cli_dp_row()
    print(json.dumps({"dp_run": f"cli_train_dp_auto_x{world}",
                      "card": smi.splitlines()[0], **cli}), flush=True)
    plan = res[0][0]["sign_ef"]["plan_bytes_per_step"] if world > 1 else 0
    if not (cli["data_parallel"] == world and cli["test_acc"] > cs.MLP_MIN_ACC
            and cli["comm_bytes_per_step"] == plan):
        raise AssertionError(f"cli train --dp auto over {world} cards: {cli}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
