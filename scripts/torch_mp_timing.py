"""Time the port's model parallelism on the cards of one host.

    python3 scripts/torch_mp_timing.py [--steps N] [--runs tp4 dp2tp2 pp4 tpp]
    python3 scripts/torch_mp_timing.py --phase14

By default: one NCCL rank a card (four cards), ``--steps`` timed steps
(default 50, after 5 untimed ones) of each run:

  tp4      ``bnn-mlp-large`` (``chip_smoke.py``'s phase 14 recipe: SGD
           0.05, global batch 64, pallas_xnor, dropout 0) at
           tensor_parallel = 4
  dp2tp2   the same at data 2 x model 2
  pp4      the LM at the ``--lm-bench`` width (vocab 256, embed 256,
           depth 4, 4 heads, 8 x 1024 tokens, flash attention, Adam
           1e-3) pipelined over 4 stages of 4 microbatches
  tpp      ``make_tp_pipeline_fn`` at (data 1, model 2, pipe 2), d 1024,
           hidden 4096, batch 256, 2 microbatches, SGD 0.01

For each: every rank's step time on the host clock (synchronised at the
end of the timed steps), the model and pipe groups' collectives a step
from CUDA events (``parallel.mesh.COMM_EVENTS``: an NCCL kernel's time
includes its wait for the peers), the wire bytes a step against the plan
(the run fails if they differ), ``torch.cuda.max_memory_allocated``, and
for the pipelines each stage's compute a step from CUDA events, its
measured idle share (1 - compute / step time) beside
``pipeline_bubble_fraction``; the TP runs' ranks must end with equal
losses. One JSON line a run and rank, then the cards' name and power
limit. ``--phase14`` runs ``chip_smoke.py``'s phase 14 alone (one card).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WARMUP = 5
SOURCES = ["xnor_gemm.cu", "flash_attn.cu", "flash_bwd.cu"]  # K1, K4-K6
PP = dict(vocab=256, embed_dim=256, depth=4, num_heads=4, mlp_ratio=2,
          seq=1024, batch=8, lr=1e-3)
TPP = dict(d_model=1024, d_hidden=4096, batch=256, n_micro=2, lr=0.01)


def _ms(events) -> float:
    return sum(s.elapsed_time(e) for s, e in events)


def _group_bytes(wire, level: str) -> int:
    return sum(n for (lv, _), n in wire.items() if lv == level)


def _tp_run(device, dp: int, tp: int, steps: int) -> dict:
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.parallel import mesh, tp_wire_plan
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    t = Trainer(TrainConfig(device=str(device), data_parallel=dp,
                            tensor_parallel=tp, log_interval=1,
                            **cs.MP_TRAIN))
    rng = np.random.RandomState(14)
    xs = rng.randn(WARMUP + steps, cs.MP_BATCH, 784).astype(np.float32)
    ys = rng.randint(0, 10, (WARMUP + steps, cs.MP_BATCH))
    batches = [(torch.from_numpy(t._shard(x)).to(device),
                torch.from_numpy(t._shard(y)).to(device))
               for x, y in zip(xs, ys)]

    def run(some):
        return [t.train_step(t.model, t.optimizer, x, y)[0] for x, y in some]

    run(batches[:WARMUP])
    torch.cuda.synchronize()
    t.wire.clear()
    _kernels.reset_launches()
    mesh.COMM_EVENTS["model"] = []
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    losses = run(batches[WARMUP:])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    comm_ms = _ms(mesh.COMM_EVENTS.pop("model")) / steps
    plan = tp_wire_plan(get_model("bnn-mlp-large"), tp=tp, dp=dp,
                        batch=cs.MP_BATCH)
    got = {"model": _group_bytes(t.wire, "model") // steps,
           "data": _group_bytes(t.wire, "inter") // steps}
    if got != {"model": plan["model"], "data": plan["data"]}:
        raise AssertionError(f"dp{dp}xtp{tp}: {got} bytes a step, the "
                             f"plan's {plan}")
    return {"step_ms": step_ms, "model_comm_ms": comm_ms,
            "wire_per_step": got, "plan": plan,
            "k1_per_step": _kernels.LAUNCHES["xnor"] / steps,
            "peak_mb": torch.cuda.max_memory_allocated(device) / 2 ** 20,
            "loss": float(losses[-1]),
            "examples_per_s": cs.MP_BATCH / step_ms * 1e3}


def _pp_plan(stage: int, n: int, n_micro: int, act: int, out: int,
             embed: int) -> int:
    """Pipe-group bytes out of stage ``stage`` a step: its microbatches'
    activations forward (not the last), their gradients backward (not
    the first), the output broadcast from the last to the n - 1 others,
    the embedding's gradients all-reduced (ring)."""
    b = 0
    if stage < n - 1:
        b += n_micro * act
    if stage > 0:
        b += n_micro * act
    if stage == n - 1:
        b += (n - 1) * out
    return b + 2 * (n - 1) * embed // n


def _pp_run(device, steps: int) -> dict:
    import torch.distributed as dist

    from distributed_mnist_bnns_tpu_torch.examples import lm_demo
    from distributed_mnist_bnns_tpu_torch.models import (
        BinarizedLM,
        latent_clamp_mask,
    )
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops.comm_compress import WireBytes
    from distributed_mnist_bnns_tpu_torch.parallel import (
        Mesh,
        PipelinedModel,
        mesh,
        pipeline_bubble_fraction,
    )

    n = dist.get_world_size()
    wire = WireBytes()
    model = BinarizedLM(vocab=PP["vocab"], max_len=PP["seq"],
                        embed_dim=PP["embed_dim"], depth=PP["depth"],
                        num_heads=PP["num_heads"], mlp_ratio=PP["mlp_ratio"],
                        attention="flash",
                        generator=torch.Generator().manual_seed(0)).to(device)
    pm = PipelinedModel(model, Mesh((n,), ("pipe",)), n_micro=n, wire=wire)
    latents = list(latent_clamp_mask(pm).values())
    opt = lm_demo.make_optimizer(pm, PP["lr"])
    _, draw = lm_demo.token_stream(PP["seq"], PP["batch"], PP["vocab"], 0)
    tokens = torch.from_numpy(draw()).to(device)
    for _ in range(WARMUP):
        lm_demo._pp_step(pm, opt, latents, tokens)
    torch.cuda.synchronize()
    wire.clear()
    _kernels.reset_launches()
    mesh.COMM_EVENTS["pipe"] = []
    pm.sched.timer = []
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = lm_demo._pp_step(pm, opt, latents, tokens)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    busy = _ms(pm.sched.timer) / steps
    pm.sched.timer = None
    comm_ms = _ms(mesh.COMM_EVENTS.pop("pipe")) / steps
    act = PP["batch"] // n * PP["seq"] * PP["embed_dim"] * 4
    embed = (PP["vocab"] + PP["seq"]) * PP["embed_dim"] * 4
    plan = _pp_plan(pm.sched.stage, n, n, act, n * act, embed)
    got = _group_bytes(wire, "pipe") // steps
    if got != plan:
        raise AssertionError(f"pp{n} stage {pm.sched.stage}: {got} bytes "
                             f"a step, the plan's {plan}")
    return {"stage": pm.sched.stage, "step_ms": step_ms,
            "compute_ms": busy, "idle_share": 1.0 - busy / step_ms,
            "bubble_fraction": pipeline_bubble_fraction(n, n),
            "pipe_comm_ms": comm_ms, "wire_per_step": got,
            "flash_per_step": {k: _kernels.LAUNCHES[k] / steps for k in (
                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
            "peak_mb": torch.cuda.max_memory_allocated(device) / 2 ** 20,
            "loss": float(loss),
            "tokens_per_s": PP["batch"] * PP["seq"] / step_ms * 1e3}


def _tpp_run(device, steps: int) -> dict:
    from distributed_mnist_bnns_tpu_torch.ops.comm_compress import WireBytes
    from distributed_mnist_bnns_tpu_torch.parallel import (
        init_tp_pipeline_params,
        latent_mask,
        make_mesh,
        make_tp_pipeline_fn,
        mesh,
        pipeline_bubble_fraction,
    )

    m = make_mesh(data=1, model=2, pipe=2)
    wire = WireBytes()
    f = make_tp_pipeline_fn(m, n_micro=TPP["n_micro"], wire=wire)
    params = {k: v.to(device).requires_grad_() for k, v in
              init_tp_pipeline_params(torch.Generator().manual_seed(3), 2,
                                      TPP["d_model"],
                                      TPP["d_hidden"]).items()}
    mask = latent_mask(params)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(TPP["batch"], TPP["d_model"]).astype(
        np.float32)).to(device)
    target = torch.from_numpy(rng.randn(TPP["batch"], TPP["d_model"])
                              .astype(np.float32)).to(device)

    def step():
        loss = ((f(params, x) - target) ** 2).mean()
        loss.backward()
        with torch.no_grad():
            for k, v in params.items():
                v -= TPP["lr"] * v.grad
                v.grad = None
                if mask[k]:
                    v.clamp_(-1.0, 1.0)
        return loss.detach()

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    wire.clear()
    mesh.COMM_EVENTS["model"], mesh.COMM_EVENTS["pipe"] = [], []
    f.schedule.timer = []
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    busy = _ms(f.schedule.timer) / steps
    f.schedule.timer = None
    model_ms = _ms(mesh.COMM_EVENTS.pop("model")) / steps
    pipe_ms = _ms(mesh.COMM_EVENTS.pop("pipe")) / steps
    stage, n_micro = f.schedule.stage, TPP["n_micro"]
    mb = TPP["batch"] // n_micro * TPP["d_model"] * 4
    # ring all-reduces over 2 model ranks move their buffer's bytes: the
    # row-parallel output forward, the column input's gradient backward
    # (stage 0's input needs none)
    plan = {"model": n_micro * mb * (1 if stage == 0 else 2),
            "pipe": _pp_plan(stage, 2, n_micro, mb, n_micro * mb, 0)}
    got = {"model": _group_bytes(wire, "model") // steps,
           "pipe": _group_bytes(wire, "pipe") // steps}
    if got != plan:
        raise AssertionError(f"tpp stage {stage}: {got} bytes a step, the "
                             f"plan's {plan}")
    return {"stage": stage, "model_rank": m.index("model"),
            "step_ms": step_ms, "compute_ms": busy,
            "idle_share": 1.0 - busy / step_ms,
            "bubble_fraction": pipeline_bubble_fraction(2, n_micro),
            "model_comm_ms": model_ms, "pipe_comm_ms": pipe_ms,
            "wire_per_step": got,
            "peak_mb": torch.cuda.max_memory_allocated(device) / 2 ** 20,
            "loss": float(loss)}


def _rank(rank: int, world: int, device, steps: int, runs: list) -> dict:
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build(sources=SOURCES)
    out = {}
    for name in runs:
        if name == "tp4":
            out[name] = _tp_run(device, 1, world, steps)
        elif name == "dp2tp2":
            out[name] = _tp_run(device, world // 2, 2, steps)
        elif name == "pp4":
            out[name] = _pp_run(device, steps)
        elif name == "tpp":
            out[name] = _tpp_run(device, steps)
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--runs", nargs="+",
                   default=["tp4", "dp2tp2", "pp4", "tpp"])
    p.add_argument("--phase14", action="store_true")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_mp_timing: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    if a.phase14:
        import chip_smoke as cs
        from distributed_mnist_bnns_tpu_torch.ops import _kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        _kernels.build()
        print(json.dumps(cs.mp_phase(torch.device("cuda", 0),
                                     torch.Generator().manual_seed(0),
                                     smi.splitlines()[0])[0]))
        print(smi)
        return 0
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.parallel import spawn

    _kernels.build(sources=SOURCES)   # once, before the ranks load them
    world = torch.cuda.device_count()
    if world != 4:
        raise SystemExit(f"the runs are laid out for 4 cards, have {world}")
    t0 = time.perf_counter()
    res = spawn(_rank, world, backend="nccl", device="cuda",
                args=(a.steps, a.runs))
    for name in a.runs:
        rows = [r[name] for r in res]
        if name in ("tp4", "dp2tp2") and len({r["loss"] for r in rows}) != 1:
            raise AssertionError(f"{name}: the ranks' losses differ")
        for rank, row in enumerate(rows):
            print(json.dumps({"run": name, "rank": rank, **row}), flush=True)
    print(json.dumps({"total_s": time.perf_counter() - t0}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
