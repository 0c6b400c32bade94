"""Command line for the port: ``train``, ``eval``, ``export``, ``infer``,
``serve`` and ``lm``.

  python -m distributed_mnist_bnns_tpu_torch.cli train --model bnn-mlp-large \
      --epochs 5 --batch-size 64 --lr 0.01 --checkpoint-dir ckpt
  python -m distributed_mnist_bnns_tpu_torch.cli train --dp auto \
      --grad-compress sign_ef
  python -m distributed_mnist_bnns_tpu_torch.cli train --model convnet \
      --precision bf16 --dp auto
  python -m distributed_mnist_bnns_tpu_torch.cli train --model bnn-cnn \
      --backend pallas_xnor --checkpoint-dir ckpt
  python -m distributed_mnist_bnns_tpu_torch.cli export --model bnn-cnn \
      --checkpoint-dir ckpt --out cnn.pt
  python -m distributed_mnist_bnns_tpu_torch.cli eval --checkpoint-dir ckpt
  python -m distributed_mnist_bnns_tpu_torch.cli export --checkpoint-dir ckpt \
      --out m.pt
  python -m distributed_mnist_bnns_tpu_torch.cli export --out m.pt
  python -m distributed_mnist_bnns_tpu_torch.cli infer --artifact m.pt
  python -m distributed_mnist_bnns_tpu_torch.cli serve --artifact m.pt
  python -m distributed_mnist_bnns_tpu_torch.cli lm --export lm.pt
  python -m distributed_mnist_bnns_tpu_torch.cli lm --steps 200 --export lm.pt
  python -m distributed_mnist_bnns_tpu_torch.cli serve --lm --artifact lm.pt
  python -m distributed_mnist_bnns_tpu_torch.cli lm --load lm.pt --sample 32

``train`` trains a registered model (``models.list_models()``: the
bnn-mlp family, ``fp32-mlp-large``, ``convnet``, ``deep-cnn``,
``bnn-cnn``; ``train.Trainer``; MNIST, or synthetic data when no idx
files are found; ``--precision bf16`` computes in bf16 over fp32
parameters where the model takes a dtype) and prints its final
metrics as one JSON line; with ``--dp N`` (or ``auto``: one rank a card)
it starts N ranks itself, over NCCL on the cards or over gloo with
``--device cpu``, and ``--grad-compress sign|sign_ef`` exchanges 1-bit
gradients (``--dp-hosts``: in two levels); ``eval`` evaluates the
latest (``--best``: the best) checkpoint of a ``train --checkpoint-dir``
run. ``export`` freezes
a ``bnn-mlp`` or ``bnn-cnn`` model (a trained checkpoint with
``--checkpoint-dir``, a seeded init, or weights carried across from the
JAX package with ``--jax-variables``) into the port's packed artifact;
``infer`` evaluates an artifact on the MNIST test split (synthetic data
when no idx files are found); ``serve`` runs the HTTP
server (``--lm``: the continuous-batching LM server); ``lm --export``
freezes a BinarizedLM (seeded init, or JAX weights with
``--jax-variables``) into a packed LM artifact, ``lm --steps N`` first
trains it N steps (``examples/lm_demo.py::run``; flash attention by
default) and exports the trained model, and ``lm --load --sample``
generates from one greedily. ``--device`` defaults to ``cuda`` and never
falls back to the CPU: pass ``--device cpu`` to run there.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

log = logging.getLogger(__name__)

#: the models ``export`` freezes
FREEZABLE = ("bnn-mlp-large", "bnn-mlp-small", "bnn-cnn")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="distributed_mnist_bnns_tpu_torch")
    p.add_argument("--log-level", default="INFO")
    sub = p.add_subparsers(dest="cmd", required=True)

    for cmd, what in (("train", "train a registered model"),
                      ("eval", "evaluate a train run's checkpoint")):
        _train_flags(sub.add_parser(cmd, help=what))

    x = sub.add_parser(
        "export", help="freeze a bnn-mlp or bnn-cnn model into a packed "
                       "artifact",
    )
    x.add_argument("--model", default="bnn-mlp-large",
                   choices=list(FREEZABLE))
    x.add_argument("--infl-ratio", type=int, default=3)
    x.add_argument("--checkpoint-dir", default=None,
                   help="freeze the latest checkpoint of a train run "
                        "(its --model and --infl-ratio)")
    x.add_argument("--best", action="store_true",
                   help="with --checkpoint-dir: the best checkpoint")
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
    sv.add_argument("--lm", action="store_true",
                    help="serve a packed LM artifact (`lm --export`) "
                         "through the continuous-batching engine: POST "
                         "/generate streams tokens as ndjson")
    sv.add_argument("--slots", type=int, default=4,
                    help="--lm: decode batch width")
    sv.add_argument("--page-size", type=int, default=16,
                    help="--lm: tokens per KV page")
    sv.add_argument("--num-pages", type=int, default=None,
                    help="--lm: KV pool pages (default: every slot can "
                         "reach max_len at once, plus the null page)")
    sv.add_argument("--prefill-chunk", type=int, default=16,
                    help="--lm: prompt positions per prefill call")
    sv.add_argument("--max-len", type=int, default=None,
                    help="--lm: cap sequences below the artifact's window")
    sv.add_argument("--device", default="cuda")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000,
                    help="0 = pick an ephemeral port (logged)")
    sv.add_argument("--batch-size", type=int, default=32,
                    help="micro-batch shape; queued requests coalesce up "
                         "to it and the remainder is padded")
    sv.add_argument("--queue-depth", type=int, default=64)
    sv.add_argument("--deadline-ms", type=float, default=None,
                    help="default request deadline (1000, or 30000 for "
                         "--lm: a stream spans many iterations)")
    sv.add_argument("--linger-ms", type=float, default=2.0)
    sv.add_argument("--stall-timeout-s", type=float, default=1.0)
    sv.add_argument("--breaker-threshold", type=int, default=3)
    sv.add_argument("--breaker-reset-s", type=float, default=5.0)
    sv.add_argument("--breaker-probes", type=int, default=1)
    sv.add_argument("--drain-timeout-s", type=float, default=30.0)
    sv.add_argument("--input-shape", type=int, nargs="+",
                    default=[28, 28, 1])

    lm = sub.add_parser(
        "lm", help="train and/or export a packed BinarizedLM artifact, or "
                   "sample from one",
    )
    lm.add_argument("--export", default=None, metavar="PATH",
                    help="freeze a BinarizedLM (seeded init, or "
                         "--jax-variables) into a packed LM artifact")
    lm.add_argument("--jax-variables", default=None, metavar="NPZ",
                    help="with --export: the JAX BinarizedLM's params from "
                         "an .npz with '/'-joined keys "
                         "(params/tok_embed/embedding, ...)")
    lm.add_argument("--steps", type=int, default=0,
                    help="train this many steps (examples/lm_demo.py) "
                         "before --export; 0: export the seeded init")
    lm.add_argument("--seq-len", type=int, default=32,
                    help="training sequence length (the model's max_len "
                         "when training)")
    lm.add_argument("--batch-size", type=int, default=16)
    lm.add_argument("--lr", type=float, default=3e-3)
    lm.add_argument("--attention", default="flash", choices=["xla", "flash"],
                    help="training attention: flash runs the kernels K4-K6 "
                         "on a card")
    lm.add_argument("--corpus", default=None,
                    help="train byte-level (vocab 256) on random windows of "
                         "this file (default: a periodic synthetic corpus)")
    lm.add_argument("--vocab", type=int, default=256)
    lm.add_argument("--max-len", type=int, default=256,
                    help="with --export and no --steps: the position window")
    lm.add_argument("--embed-dim", type=int, default=256)
    lm.add_argument("--depth", type=int, default=4)
    lm.add_argument("--num-heads", type=int, default=4)
    lm.add_argument("--mlp-ratio", type=int, default=2)
    lm.add_argument("--scale", action="store_true",
                    help="XNOR-Net per-output alpha on the projections")
    lm.add_argument("--seed", type=int, default=0,
                    help="seed of the torch.Generator of the weights")
    lm.add_argument("--load", default=None, metavar="PATH",
                    help="load a packed LM artifact and greedily generate "
                         "--sample tokens through the KV-cache decoder")
    lm.add_argument("--sample", type=int, default=64)
    lm.add_argument("--prompt", default="\n",
                    help="with --load: text prompt (UTF-8 bytes mod vocab)")
    lm.add_argument("--device", default="cuda")
    return p


def _train_flags(sp: argparse.ArgumentParser) -> None:
    """The flags of ``train`` and ``eval``, with the JAX CLI's defaults."""
    from .models import list_models
    from .ops.losses import LOSSES
    from .ops.xnor_gemm import BACKENDS

    sp.add_argument("--model", default="bnn-mlp-large",
                    choices=list_models())
    sp.add_argument("--infl-ratio", type=int, default=3,
                    help="width multiplier of the MLPs")
    sp.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                    help="bf16: bf16 compute over fp32 parameters in the "
                         "models that take a dtype (the reference's AMP)")
    sp.add_argument("--epochs", type=int, default=5)
    sp.add_argument("--batch-size", type=int, default=64)
    sp.add_argument("--optimizer", default="adam")
    sp.add_argument("--lr", type=float, default=0.01)
    sp.add_argument("--lr-schedule", default="step",
                    choices=["step", "cosine"],
                    help="step: x0.1 every 40 epochs; cosine anneals to 0 "
                         "over --epochs")
    sp.add_argument("--warmup-epochs", type=int, default=0)
    sp.add_argument("--clip-grad-norm", type=float, default=None,
                    help="global-norm gradient clipping threshold")
    sp.add_argument("--seed", type=int, default=42,
                    help="seeds the weights, the dropout and stochastic "
                         "draws and the data order")
    sp.add_argument("--log-interval", type=int, default=100)
    sp.add_argument("--backend", default=None, choices=list(BACKENDS),
                    help="GEMM backend of the binarized layers (default "
                         "bf16; pallas_xnor runs K1)")
    sp.add_argument("--stochastic", action="store_true",
                    help="stochastic activation binarization in training")
    sp.add_argument("--dropout", type=float, default=None,
                    help="dropout rate (the MLPs': before the third "
                         "BatchNorm, default 0.3; deep-cnn's: 0.5)")
    sp.add_argument("--loss", default="ce", choices=list(LOSSES))
    sp.add_argument("--label-smoothing", type=float, default=0.0,
                    help="uniform target mixing for the ce loss")
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--norm", default="mnist",
                    choices=["mnist", "half", "none"])
    sp.add_argument("--synthetic-sizes", type=int, nargs=2,
                    default=[60000, 10000], metavar=("TRAIN", "TEST"),
                    help="sizes of the synthetic fallback dataset")
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--best", action="store_true",
                    help="eval: the best checkpoint instead of the latest")
    sp.add_argument("--device", default="cuda")
    # parallelism
    sp.add_argument("--dp", default="1",
                    help="'auto' = all devices, or an integer")
    sp.add_argument("--dp-mode", default="gspmd",
                    choices=["gspmd", "fsdp"],
                    help="fsdp = ZeRO-style sharded params/opt state")
    sp.add_argument("--grad-compress", default="none",
                    choices=["none", "sign", "sign_ef"],
                    help="1-bit gradient exchange: sign bitplanes + per-"
                         "bucket fp32 scales, ~32x fewer wire bytes per "
                         "step; sign = majority-vote signSGD, sign_ef = "
                         "error feedback (residuals checkpoint in the "
                         "optimizer state)")
    sp.add_argument("--dp-hosts", type=int, default=None,
                    help="two-level hierarchical compressed exchange: "
                         "factor the DP world into (hosts x local); fp32 "
                         "ring reduce within a host, 1-bit exchange "
                         "across hosts only (needs --grad-compress, "
                         "--dp-mode gspmd)")
    sp.add_argument("--compress-bucket-size", type=int, default=1024,
                    help="elements per compression scale bucket "
                         "(multiple of 32)")
    sp.add_argument("--compress-chunks", type=int, default=4,
                    help="independent overlap groups for the compressed "
                         "exchange (here the collectives block, so the "
                         "groups only split the calls; the result does "
                         "not depend on it)")


def _dp_world(args) -> int:
    """The ranks of ``--dp``: 'auto' is one a card (``--device cpu``: as
    many gloo processes as there are cards, at least one)."""
    if args.dp == "auto":
        import torch

        return max(torch.cuda.device_count(), 1)
    return int(args.dp)


def _model_kwargs(args) -> dict:
    """The model kwargs of the flags, as the JAX CLI passes them:
    ``infl_ratio`` to the MLPs only, the others when given."""
    mk = {}
    if "-mlp-" in args.model:
        mk["infl_ratio"] = args.infl_ratio
    if getattr(args, "stochastic", False):
        mk["stochastic"] = True
    if getattr(args, "dropout", None) is not None:
        mk["dropout_rate"] = args.dropout
    return mk


def _trainer(args, data_parallel=None, device=None):
    from .train import TrainConfig, Trainer

    return Trainer(TrainConfig(
        data_parallel=data_parallel, dp_mode=args.dp_mode,
        grad_compress=args.grad_compress, dp_hosts=args.dp_hosts,
        compress_bucket_size=args.compress_bucket_size,
        compress_chunks=args.compress_chunks,
        model=args.model, model_kwargs=_model_kwargs(args),
        precision=args.precision, epochs=args.epochs,
        batch_size=args.batch_size, optimizer=args.optimizer,
        learning_rate=args.lr, lr_schedule=args.lr_schedule,
        warmup_epochs=args.warmup_epochs, clip_grad_norm=args.clip_grad_norm,
        seed=args.seed, log_interval=args.log_interval, loss=args.loss,
        label_smoothing=args.label_smoothing, backend=args.backend,
        checkpoint_dir=args.checkpoint_dir,
        device=args.device if device is None else device,
    ))


def _train_data(args):
    from .data import load_mnist

    # The synthetic fallback is seed 0's whatever --seed says, as in the
    # JAX CLI, so train, eval and infer see the same data.
    return load_mnist(args.data_dir, norm=args.norm,
                      synthetic_sizes=tuple(args.synthetic_sizes))


def _fit(args, data_parallel=None, device=None) -> dict:
    trainer = _trainer(args, data_parallel, device)
    data = _train_data(args)
    history = trainer.fit(data)
    return {
        "model": args.model, "device": str(trainer.device),
        "data_source": data.source, **history[-1],
        "total_steps": trainer.step, "best_acc": trainer.best_acc,
        "checkpoint_dir": args.checkpoint_dir,
        "data_parallel": trainer.world, "grad_compress": args.grad_compress,
        "comm_bytes_per_step": trainer.comm_bytes() / max(trainer.step, 1),
    }


def _train_rank(rank: int, world: int, device, args) -> dict:
    """One rank of ``train --dp``: the trainer on this rank's device."""
    logging.basicConfig(
        level=args.log_level if rank == 0 else "WARNING",
        format=f"%(asctime)s %(levelname)s rank {rank} %(name)s: "
               "%(message)s",
    )
    return _fit(args, data_parallel=world, device=str(device))


def _train(args) -> int:
    world = _dp_world(args)
    if world <= 1:
        row = _fit(args)
    else:
        from .parallel import spawn

        # One rank a card over NCCL; on the CPU, gloo processes.
        backend = "gloo" if args.device == "cpu" else "nccl"
        row = spawn(_train_rank, world, backend=backend,
                    device="cpu" if args.device == "cpu" else "cuda",
                    args=(args,))[0]
    print(json.dumps(row))
    return 0


def _eval(args) -> int:
    if not args.checkpoint_dir:
        raise SystemExit("eval requires --checkpoint-dir")
    trainer = _trainer(args)
    payload = trainer.restore(args.checkpoint_dir, best=args.best)
    data = _train_data(args)
    print(json.dumps({
        "model": args.model, "device": str(trainer.device),
        "data_source": data.source, "checkpoint_epoch": payload["epoch"],
        "checkpoint_step": payload["step"], **trainer.evaluate(data),
    }))
    return 0


def _export(args) -> int:
    import torch

    from .infer import export_packed
    from .models import get_model

    if args.checkpoint_dir and args.jax_variables:
        raise SystemExit("export: give at most one of --checkpoint-dir and "
                         "--jax-variables")
    if args.checkpoint_dir:
        from .train import load_checkpoint

        try:
            payload = load_checkpoint(args.checkpoint_dir, best=args.best,
                                      model=args.model)
        except ValueError as e:
            raise SystemExit(f"export: {e}") from None
        model = get_model(args.model, **_model_kwargs(args))
        model.load_state_dict(payload["state_dict"])
        model.eval()
    elif args.jax_variables:
        from .interop import params_from_jax, variables_from_npz

        model = params_from_jax(variables_from_npz(args.jax_variables))
    else:
        gen = torch.Generator().manual_seed(args.seed)
        model = get_model(args.model, generator=gen,
                          **_model_kwargs(args)).eval()
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
    if args.lm:
        from .serve.lm import LMServeConfig, LMServer

        return LMServer(LMServeConfig(
            artifact=args.artifact,
            device=args.device,
            host=args.host,
            port=args.port,
            slots=args.slots,
            page_size=args.page_size,
            num_pages=args.num_pages,
            prefill_chunk=args.prefill_chunk,
            max_len=args.max_len,
            queue_depth=args.queue_depth,
            default_deadline_ms=(30000.0 if args.deadline_ms is None
                                 else args.deadline_ms),
            drain_timeout_s=args.drain_timeout_s,
        )).run()
    from .serve import PackedInferenceServer, ServeConfig

    server = PackedInferenceServer(ServeConfig(
        artifact=args.artifact,
        device=args.device,
        host=args.host,
        port=args.port,
        batch_size=args.batch_size,
        queue_depth=args.queue_depth,
        default_deadline_ms=(1000.0 if args.deadline_ms is None
                             else args.deadline_ms),
        linger_ms=args.linger_ms,
        stall_timeout_s=args.stall_timeout_s,
        breaker_threshold=args.breaker_threshold,
        breaker_reset_s=args.breaker_reset_s,
        breaker_probes=args.breaker_probes,
        drain_timeout_s=args.drain_timeout_s,
        input_shape=tuple(args.input_shape),
    ))
    return server.run()


def _lm(args) -> int:
    import torch

    from .infer import export_packed, load_frozen
    from .infer_transformer import generate, make_lm_decoder
    from .models import BinarizedLM

    if args.steps < 0:
        raise SystemExit(f"lm: --steps must be >= 0, got {args.steps}")
    if args.steps and (args.load or args.jax_variables):
        raise SystemExit("lm: --steps trains a seeded init; it takes "
                         "neither --load nor --jax-variables")
    if args.steps:
        from .examples.lm_demo import run

        res = run(
            steps=args.steps, seq_len=args.seq_len, batch=args.batch_size,
            vocab=args.vocab, embed_dim=args.embed_dim, depth=args.depth,
            num_heads=args.num_heads, mlp_ratio=args.mlp_ratio,
            scale=args.scale, lr=args.lr, seed=args.seed,
            attention=args.attention, corpus=args.corpus,
            export=args.export, device=args.device,
        )
        print(json.dumps({"steps": args.steps, "loss_history": res.history,
                          **({"artifact": args.export, **res.export}
                             if args.export else {})}))
        return 0
    if bool(args.export) == bool(args.load):
        raise SystemExit("lm: give exactly one of --export and --load")
    if args.export:
        if args.jax_variables:
            from .interop import lm_params_from_jax, variables_from_npz

            model = lm_params_from_jax(
                variables_from_npz(args.jax_variables)["params"],
                num_heads=args.num_heads, scale=args.scale,
            )
        else:
            model = BinarizedLM(
                vocab=args.vocab, max_len=args.max_len,
                embed_dim=args.embed_dim, depth=args.depth,
                num_heads=args.num_heads, mlp_ratio=args.mlp_ratio,
                scale=args.scale,
                generator=torch.Generator().manual_seed(args.seed),
            ).eval()
        info = export_packed(model, args.export)
        print(json.dumps({"artifact": args.export, **info}))
        return 0
    frozen = load_frozen(args.load)
    if frozen.get("kind") != "lm":
        raise SystemExit(f"lm: {args.load} is not a packed LM artifact")
    if args.sample < 1:
        raise SystemExit(f"lm: --sample must be >= 1, got {args.sample}")
    vocab = int(frozen["tok_embed"].shape[0])
    max_len = int(frozen["pos_embed"].shape[1])
    prompt = [b % vocab for b in args.prompt.encode("utf-8")]
    if len(prompt) >= max_len:
        raise SystemExit(f"lm: the prompt fills the window ({max_len})")
    n = min(args.sample, max_len - len(prompt))
    toks = generate(frozen, [prompt], n,
                    decoder=make_lm_decoder(frozen, device=args.device))
    out = [int(t) for t in toks[0, len(prompt):]]
    print(json.dumps({
        "tokens": out,
        "text": bytes(out).decode("utf-8", "replace") if vocab == 256 else None,
    }))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    return {"train": _train, "eval": _eval, "export": _export,
            "infer": _infer, "serve": _serve, "lm": _lm}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
