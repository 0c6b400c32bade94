"""Command line for the port: ``export``, ``infer`` and ``serve``.

  python -m distributed_mnist_bnns_tpu_torch.cli export --out m.pt
  python -m distributed_mnist_bnns_tpu_torch.cli infer --artifact m.pt
  python -m distributed_mnist_bnns_tpu_torch.cli serve --artifact m.pt

``export`` freezes a ``bnn-mlp`` model (seeded init, or weights carried
across from the JAX package with ``--jax-variables``) into the port's
packed artifact; ``infer`` evaluates an artifact on the MNIST test split
(synthetic data when no idx files are found); ``serve`` runs the HTTP
server. ``--device`` defaults to ``cuda`` and never falls back to the
CPU: pass ``--device cpu`` to run there.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="distributed_mnist_bnns_tpu_torch")
    p.add_argument("--log-level", default="INFO")
    sub = p.add_subparsers(dest="cmd", required=True)

    x = sub.add_parser(
        "export", help="freeze a bnn-mlp model into a packed artifact",
    )
    x.add_argument("--model", default="bnn-mlp-large",
                   choices=["bnn-mlp-large", "bnn-mlp-small"])
    x.add_argument("--infl-ratio", type=int, default=3)
    x.add_argument("--seed", type=int, default=0,
                   help="seed of the torch.Generator the weights are "
                        "drawn from (ignored with --jax-variables)")
    x.add_argument("--jax-variables", default=None, metavar="NPZ",
                   help="load the JAX package's {params, batch_stats} "
                        "from an .npz with '/'-joined keys instead of a "
                        "seeded init (interop.variables_from_npz)")
    x.add_argument("--out", default="model_packed.pt")

    inf = sub.add_parser(
        "infer", help="evaluate a packed artifact on the MNIST test split",
    )
    inf.add_argument("--artifact", required=True)
    inf.add_argument("--device", default="cuda")
    inf.add_argument("--batch-size", type=int, default=64)
    inf.add_argument("--data-dir", default=None)
    inf.add_argument("--norm", default="mnist",
                     choices=["mnist", "half", "none"])
    inf.add_argument("--seed", type=int, default=0,
                     help="seed of the synthetic fallback data")
    inf.add_argument("--synthetic-sizes", type=int, nargs=2,
                     default=[60000, 10000], metavar=("TRAIN", "TEST"),
                     help="sizes of the synthetic fallback dataset")

    sv = sub.add_parser(
        "serve", help="long-running HTTP server over a packed artifact",
    )
    sv.add_argument("--artifact", required=True)
    sv.add_argument("--device", default="cuda")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000,
                    help="0 = pick an ephemeral port (logged)")
    sv.add_argument("--batch-size", type=int, default=32,
                    help="micro-batch shape; queued requests coalesce up "
                         "to it and the remainder is padded")
    sv.add_argument("--queue-depth", type=int, default=64)
    sv.add_argument("--deadline-ms", type=float, default=1000.0)
    sv.add_argument("--linger-ms", type=float, default=2.0)
    sv.add_argument("--stall-timeout-s", type=float, default=1.0)
    sv.add_argument("--breaker-threshold", type=int, default=3)
    sv.add_argument("--breaker-reset-s", type=float, default=5.0)
    sv.add_argument("--breaker-probes", type=int, default=1)
    sv.add_argument("--drain-timeout-s", type=float, default=30.0)
    sv.add_argument("--input-shape", type=int, nargs="+",
                    default=[28, 28, 1])
    return p


def _export(args) -> int:
    import torch

    from .infer import export_packed
    from .models import get_model

    if args.jax_variables:
        from .interop import params_from_jax, variables_from_npz

        model = params_from_jax(variables_from_npz(args.jax_variables))
    else:
        gen = torch.Generator().manual_seed(args.seed)
        model = get_model(
            args.model, infl_ratio=args.infl_ratio, generator=gen
        ).eval()
    info = export_packed(model, args.out)
    print(json.dumps({"artifact": args.out, **info}))
    return 0


def _infer(args) -> int:
    import numpy as np

    from .data import load_mnist
    from .infer import load_packed

    fn, info = load_packed(args.artifact, device=args.device)
    data = load_mnist(args.data_dir, norm=args.norm, seed=args.seed,
                      synthetic_sizes=tuple(args.synthetic_sizes))
    bs = args.batch_size
    fn(data.test_images[:bs]).cpu()  # build + load the kernels first
    correct = total = full_batches = 0
    t_sum = 0.0
    for start in range(0, len(data.test_labels), bs):
        x = data.test_images[start:start + bs]
        y = data.test_labels[start:start + bs]
        t0 = time.perf_counter()
        preds = fn(x).argmax(-1).cpu().numpy()  # the copy synchronises
        if len(y) == bs:
            t_sum += time.perf_counter() - t0
            full_batches += 1
        correct += int((preds == np.asarray(y)).sum())
        total += len(y)
    print(json.dumps({
        "artifact": args.artifact,
        "family": info.get("family"),
        "data_source": data.source,
        "device": args.device,
        "test_acc": round(100.0 * correct / max(total, 1), 2),
        "n_examples": total,
        "avg_batch_latency_ms": round(
            t_sum / max(full_batches, 1) * 1e3, 3
        ),
        "compression": info.get("compression"),
    }))
    return 0


def _serve(args) -> int:
    from .serve import PackedInferenceServer, ServeConfig

    server = PackedInferenceServer(ServeConfig(
        artifact=args.artifact,
        device=args.device,
        host=args.host,
        port=args.port,
        batch_size=args.batch_size,
        queue_depth=args.queue_depth,
        default_deadline_ms=args.deadline_ms,
        linger_ms=args.linger_ms,
        stall_timeout_s=args.stall_timeout_s,
        breaker_threshold=args.breaker_threshold,
        breaker_reset_s=args.breaker_reset_s,
        breaker_probes=args.breaker_probes,
        drain_timeout_s=args.drain_timeout_s,
        input_shape=tuple(args.input_shape),
    ))
    return server.run()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    return {"export": _export, "infer": _infer, "serve": _serve}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
