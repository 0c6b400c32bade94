"""Profile windows of the port's training step, one after another in one
process for ``--minutes``, to see whether a ``torch.profiler`` capture
keeps every kernel the step launched as the process ages, and what the
capture says of the card's clock against the host's.

    python scripts/torch_profile_edges.py [--minutes M] [--edges 0,0.25]
        [--steps 16] [--out chiprun_out/profile_edges.jsonl]
    python scripts/torch_profile_edges.py --summarize FILE

Each window is what ``Trainer``'s ``profile_step_window`` does on the
eager path: ``obs.ProfileManager.start``, ``--steps`` dispatches of
``chip_smoke.py``'s flagship step (``bnn-mlp-large``, batch 64, Adam
0.01, ``pallas_xnor``, so K1 twice a step) each in a ``jg_step`` region,
``stop``. The windows take turns over ``--edges``: the idle time at each
edge of the capture (``obs.profile.EDGE_S``, set per window). With
``--graph-sessions``, a ``torch.profiler`` session over one replay of
the step captured as a CUDA graph (``scan_steps=8``) comes before each
window, as ``chip_smoke.py``'s phases 12 and 13 profile their replays.
Importing the package keeps CUPTI up between sessions
(``TEARDOWN_CUPTI=0``, ``obs/profile.py``); run with ``TEARDOWN_CUPTI=1``
to tear it down after each session as ``torch.profiler`` does by
default.

Per window, one JSON line in ``--out``: the process's age, the edge,
the K1 launches the counters saw inside the window against the K1
kernels in the capture, and ``chip_smoke.capture_clock``'s reading (each
kernel's start less its launch call's start, and the launch calls whose
kernel is missing, with where they lie in the window). On standard
output, every ``--report`` minutes and at the end, by edge: the windows,
those short of K1, those with any kernel missing (an orphan launch
call), those whose least lag is below 0 and below -500 us, and the
least and median of the windows' least lags; with the card's name and
power limit. ``--summarize FILE`` prints that report of a finished
run's lines again (no card needed).

Exits 1 without CUDA (but with ``--summarize``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report(rows, smi: str, final: bool = False) -> None:
    by_edge = {}
    for r in rows:
        by_edge.setdefault(r["edge_s"], []).append(r)
    out = {"age_s": rows[-1]["age_s"] if rows else 0.0, "final": final,
           "card": smi,
           "teardown_cupti": rows[0].get("teardown_cupti") if rows else None,
           "graph_sessions": rows[0].get("graph_sessions") if rows else None}
    for edge, rs in sorted(by_edge.items()):
        lags = sorted(r["lag_min_us"] for r in rs
                      if r["lag_min_us"] is not None)
        short = [r for r in rs if r["k1_trace"] != r["k1_launched"]]
        out[f"edge_{edge}"] = {
            "windows": len(rs), "short": len(short),
            "first_short_age_s": short[0]["age_s"] if short else None,
            "with_orphans": sum(1 for r in rs if r["orphans"]),
            "lag_below_0": sum(1 for x in lags if x < 0),
            "lag_below_500us": sum(1 for x in lags if x < -500),
            "lag_min_us": lags[0] if lags else None,
            "lag_min_p50_us": lags[len(lags) // 2] if lags else None,
            "lag_min_last_us": rs[-1]["lag_min_us"],
            "orphans_last": short[-1]["orphans"] if short else None,
        }
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--minutes", type=float, default=14.0)
    ap.add_argument("--edges", default="0,0.25")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--report", type=float, default=2.0)
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "profile_edges.jsonl"))
    ap.add_argument("--graph-sessions", action="store_true")
    ap.add_argument("--summarize", metavar="FILE")
    args = ap.parse_args()
    if args.summarize:
        with open(args.summarize) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        report(rows, rows[0].get("card", "card not recorded"), final=True)
        return 0
    if not torch.cuda.is_available():
        print("torch_profile_edges: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.obs import profile
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build()
    edges = [float(e) for e in args.edges.split(",")]
    bs = cs.MLP_TRAIN["batch_size"]
    tmp = tempfile.mkdtemp()
    data = load_mnist(os.path.join(tmp, "no-idx-files"),
                      synthetic_sizes=(bs, bs), seed=0)
    tr = cs._mlp_trainer(device, backend="pallas_xnor")
    x, y = tr._to_device(data.train_images[:bs], data.train_labels[:bs])
    tr.train_step(tr.model, tr.optimizer, x, y)          # warm-up
    torch.cuda.synchronize()
    replay = None
    if args.graph_sessions:
        import numpy as np

        from distributed_mnist_bnns_tpu_torch.train.capture import pinned

        n = cs.SCAN_STEPS
        data_n = load_mnist(os.path.join(tmp, "no-idx-files"),
                            synthetic_sizes=(n * bs, bs), seed=0)
        tr_g = cs._mlp_trainer(device, backend="pallas_xnor", scan_steps=n)
        xs = data_n.train_images[:n * bs].reshape(
            (n, bs) + data_n.train_images.shape[1:])
        ys = data_n.train_labels[:n * bs].reshape(n, bs)

        def replay():
            tr_g._get_train_scan()(
                tr_g.model, tr_g.optimizer,
                pinned(xs, np.float32, device), pinned(ys, np.int64, device))
            torch.cuda.synchronize()

        replay()                                        # the capture
    pm = profile.get_profiler()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    rows = []
    last_report = time.perf_counter()
    end = T0 + args.minutes * 60.0
    i = 0
    with open(args.out, "w") as f:
        while time.perf_counter() < end:
            edge = edges[i % len(edges)]
            if replay is not None:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]):
                    replay()
            profile.EDGE_S = edge
            cap = os.path.join(tmp, f"w{i}")
            age = time.perf_counter() - T0
            pm.start(cap)
            k1 = _kernels.LAUNCHES["xnor"]
            for _ in range(args.steps):
                with profile.step_annotation("train_step", "edges"):
                    tr.train_step(tr.model, tr.optimizer, x, y)
            k1 = _kernels.LAUNCHES["xnor"] - k1
            pm.stop()
            clock = cs.capture_clock(cap)
            shutil.rmtree(cap, ignore_errors=True)
            row = {"window": i, "age_s": age, "edge_s": edge, "card": smi,
                   "teardown_cupti": os.environ.get("TEARDOWN_CUPTI"),
                   "graph_sessions": replay is not None,
                   "k1_launched": k1,
                   "k1_trace": clock["kernels"].get("xnor", 0),
                   "lag_min_us": clock["lag_min_us"],
                   "lag_p50_us": clock["lag_p50_us"],
                   "launch_calls": clock["launch_calls"],
                   "orphans": clock["orphans"]}
            f.write(json.dumps(row) + "\n")
            rows.append(row)
            i += 1
            if time.perf_counter() - last_report >= args.report * 60.0:
                report(rows, smi)
                last_report = time.perf_counter()
    shutil.rmtree(tmp, ignore_errors=True)
    report(rows, smi, final=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
