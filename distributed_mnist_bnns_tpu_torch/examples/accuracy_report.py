"""The accuracy artifact (the JAX package's ``examples/accuracy_report.py``):
train the flagship BNN MLP for the reference's 5 epochs (mnist-dist2.py
defaults: Adam lr=0.01, batch 64; :34,88,90) on the MNIST data that
``load_mnist`` finds, beside its fp32 twin, and record test accuracy and
per-epoch wall times, with a train-size learning curve on request.

The report names the data it ran on (``data.source``): without the MNIST
idx files ``load_mnist`` falls back to synthetic data, and the numbers
then say nothing about MNIST.

Run: python -m distributed_mnist_bnns_tpu_torch.examples.accuracy_report \\
        --out RESULTS_TORCH.md [--epochs 5] [--models bnn-mlp-large ...] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime, timezone

# Binarized-vs-fp32 twins (identical topology, data and optimizer: the
# measured gap is the cost of binarizing)
_TWINS = {
    "bnn-mlp-large": "fp32-mlp-large",
    "xnor-resnet18": "fp32-resnet18",
    "bnn-vit-tiny": "fp32-vit-tiny",
    "bnn-vit-small": "fp32-vit-small",
}


def _trainer(model, *, epochs, batch_size, lr, seed, scan_steps,
             device_data=False, device=None):
    from ..train import TrainConfig, Trainer

    return Trainer(TrainConfig(
        model=model, epochs=epochs, batch_size=batch_size, optimizer="adam",
        learning_rate=lr, seed=seed, log_interval=1000,
        scan_steps=scan_steps, device_data=device_data, device=device,
        handle_preemption=False))


def _check_sweep_sizes(data, sizes) -> int:
    """The available train images; JAX's error for a larger size."""
    n_avail = len(data.train_labels)
    bad = [s for s in sizes if s > n_avail]
    if bad:
        raise ValueError(
            f"--sweep-sizes {bad} exceed the {n_avail} available train "
            "images; a truncated subset would mislabel the learning curve"
        )
    return n_avail


def _train_size_sweep(data, sizes, epochs, batch_size, lr, seeds,
                      scan_steps, device=None):
    """Learning curve over train-subset sizes (bnn-mlp-large): nested
    subsets chosen once, independent of seed, everything else fixed, so
    the curve isolates the data effect."""
    import numpy as np

    from ..data.common import ImageClassData

    n_avail = _check_sweep_sizes(data, sizes)
    pick_all = np.random.RandomState(123).permutation(n_avail)
    out = []
    for size in sizes:
        pick = pick_all[:size]  # nested subsets: 1k in 3k in 9k
        sub = ImageClassData(
            data.train_images[pick], data.train_labels[pick],
            data.test_images, data.test_labels,
            source=data.source, name=data.name,
        )
        accs = [_trainer("bnn-mlp-large", epochs=epochs,
                         batch_size=batch_size, lr=lr, seed=seed,
                         scan_steps=scan_steps, device=device,
                         ).fit(sub)[-1]["test_acc"] for seed in seeds]
        out.append({
            "train_size": size,
            "test_acc_per_seed": [round(a, 2) for a in accs],
            "test_acc_mean": round(sum(accs) / len(accs), 2),
        })
    return out


def run(models, epochs, batch_size, lr, seeds, out_path, scan_steps=1,
        device_data=False, sweep_sizes=None, *, device=None, data=None):
    """Fit each model for each seed on ``data`` (None: ``load_mnist()``)
    on ``device`` (None: the card), write the report to ``out_path`` and
    return its rows (and the sweep's, under ``train_size_sweep``)."""
    if epochs < 1:
        raise ValueError(f"epochs must be >= 1, got {epochs}")
    import torch

    from ..data import load_mnist
    from ..infer import resolve_device

    dev = resolve_device(device)
    if data is None:
        data = load_mnist()
    if sweep_sizes:   # refused before any training
        _check_sweep_sizes(data, sweep_sizes)
    rows = []
    for model in models:
        per_seed = [
            _trainer(model, epochs=epochs, batch_size=batch_size, lr=lr,
                     seed=seed, scan_steps=scan_steps,
                     device_data=device_data, device=dev).fit(data)
            for seed in seeds]
        # the headline is the mean over seeds (per-seed values kept): a
        # single seed sits inside the test split's noise
        history = per_seed[0]
        n = float(len(per_seed))
        rows.append({
            "model": model,
            "epochs": epochs,
            "seeds": list(seeds),
            "test_acc": sum(h[-1]["test_acc"] for h in per_seed) / n,
            "test_acc_per_seed": [round(h[-1]["test_acc"], 2)
                                  for h in per_seed],
            "test_acc_top5": sum(h[-1]["test_acc_top5"]
                                 for h in per_seed) / n,
            "test_loss": sum(h[-1]["test_loss"] for h in per_seed) / n,
            "epoch_times_s": [round(h["epoch_time_s"], 3) for h in history],
            "per_epoch_acc": [round(h["test_acc"], 2) for h in history],
        })
    by_model = {r["model"]: r for r in rows}
    gaps = {
        b: round(by_model[f]["test_acc"] - by_model[b]["test_acc"], 2)
        for b, f in _TWINS.items() if b in by_model and f in by_model
    }
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev))
    lines = [
        "# RESULTS — recorded training run",
        "",
        f"Produced by `python -m distributed_mnist_bnns_tpu_torch.examples."
        f"accuracy_report` on {datetime.now(timezone.utc).date()} "
        f"(device: {device_name}).",
        "",
        f"Setup: Adam lr={lr}, batch {batch_size}, {epochs} epochs, "
        f"accuracies averaged over seeds {list(seeds)} — otherwise the "
        "reference flagship's configuration (mnist-dist2.py:34,88,90). "
        f"Data: `{data.source}` ({len(data.train_labels)} train / "
        f"{len(data.test_labels)} test)"
        + (": synthetic data, which says nothing about MNIST accuracy"
           if data.source == "synthetic" else "") + ".",
        "",
        "| model | test acc (top-1, mean) | per-seed | top-5 | test loss | "
        "per-epoch acc (seed 0) | epoch times (s) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['model']} | {r['test_acc']:.2f}% | "
            f"{', '.join(str(a) for a in r['test_acc_per_seed'])} | "
            f"{r['test_acc_top5']:.2f}% | {r['test_loss']:.4f} | "
            f"{', '.join(str(a) for a in r['per_epoch_acc'])} | "
            f"{', '.join(str(t) for t in r['epoch_times_s'])} |"
        )
    if gaps:
        lines += [""] + [
            f"**{b} vs {_TWINS[b]} accuracy gap (identical "
            f"topology/data/optimizer): {g:+.2f}%**"
            for b, g in gaps.items()
        ]
    sweep = None
    if sweep_sizes:
        sweep = _train_size_sweep(data, sweep_sizes, epochs, batch_size, lr,
                                  seeds, scan_steps, device=dev)
        lines += [
            "",
            "## Train-size learning curve (bnn-mlp-large)",
            "",
            "Only the train-subset size varies (nested subsets, fixed "
            "across seeds; the headline's recipe otherwise).",
            "",
            "| train images | test acc per seed | mean |",
            "|---|---|---|",
        ]
        for s in sweep:
            lines.append(
                f"| {s['train_size']} | "
                f"{', '.join(str(a) for a in s['test_acc_per_seed'])} | "
                f"{s['test_acc_mean']:.2f}% |"
            )
    lines += [
        "",
        "Reference comparison: the reference published wall times only "
        "(MNIST_EPOCH_TIME(PersonalCom).csv: ~8.25 s/epoch over 60k images "
        "at batch 64) and no accuracy (mnist-dist2.py prints train loss "
        "only, :144-146).",
        "",
        "```json",
        json.dumps(rows if sweep is None
                   else rows + [{"train_size_sweep": sweep}], indent=1),
        "```",
        "",
    ]
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out_path}")
    for r in rows:
        print(f"{r['model']}: {r['test_acc']:.2f}%")
    for b, g in gaps.items():
        print(f"gap ({_TWINS[b]} - {b}): {g:+.2f}%")
    return rows if sweep is None else rows + [{"train_size_sweep": sweep}]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True,
                   help="the report's path (RESULTS.md is the JAX "
                        "package's record)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--seeds", type=int, nargs="+", default=[42, 43, 44])
    p.add_argument("--scan-steps", type=int, default=1,
                   help="S train steps a dispatch (TrainConfig.scan_steps)")
    p.add_argument("--device-data", action="store_true",
                   help="device-resident dataset (TrainConfig.device_data)")
    p.add_argument("--sweep-sizes", type=int, nargs="+", default=None,
                   help="also record a train-size learning curve for "
                        "bnn-mlp-large at these subset sizes")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument(
        "--models", nargs="+",
        default=["bnn-mlp-large", "fp32-mlp-large", "bnn-mlp-small"],
    )
    args = p.parse_args(argv)
    if args.epochs < 1:
        p.error("--epochs must be >= 1")
    return run(args.models, args.epochs, args.batch_size, args.lr,
               args.seeds, args.out, scan_steps=args.scan_steps,
               device_data=args.device_data, sweep_sizes=args.sweep_sizes,
               device=args.device)


if __name__ == "__main__":
    main()
