"""Command line for the port: ``train``, ``eval``, ``export``, ``infer``,
``serve``, ``lm``, and the readers ``telemetry``, ``trace`` and
``profile``.

  python -m distributed_mnist_bnns_tpu_torch.cli train --model bnn-mlp-large \
      --epochs 5 --batch-size 64 --lr 0.01 --checkpoint-dir ckpt
  python -m distributed_mnist_bnns_tpu_torch.cli train --checkpoint-dir ckpt \
      --resume --timing-csv timing --results results.csv
  python -m distributed_mnist_bnns_tpu_torch.cli train --dp 2 --nodes 2 \
      --node-rank 0 --coordinator 10.0.0.1:29500    # and --node-rank 1
  python -m distributed_mnist_bnns_tpu_torch.cli train --dp auto \
      --grad-compress sign_ef
  python -m distributed_mnist_bnns_tpu_torch.cli train --tp 2 --dp 2
  python -m distributed_mnist_bnns_tpu_torch.cli train --model bnn-vit-tiny \
      --tp 2 --xnor-scale --scan-steps 8
  python -m distributed_mnist_bnns_tpu_torch.cli train --dp 2 \
      --grad-compress sign_ef --elastic --checkpoint-dir ckpt \
      --chaos 'worker_lost@step=100,world=1;worker_restore@step=200'
  python -m distributed_mnist_bnns_tpu_torch.cli serve --artifact m.msgpack \
      --chaos 'infer_error@step=4,times=3'
  python -m distributed_mnist_bnns_tpu_torch.cli train --model bnn-vit-tiny \
      --pp 2
  python -m distributed_mnist_bnns_tpu_torch.cli lm --steps 100 --pp 2
  python -m distributed_mnist_bnns_tpu_torch.cli train --model convnet \
      --precision bf16 --dp auto
  python -m distributed_mnist_bnns_tpu_torch.cli train --model bnn-cnn \
      --backend pallas_xnor --checkpoint-dir ckpt
  python -m distributed_mnist_bnns_tpu_torch.cli export --model bnn-cnn \
      --checkpoint-dir ckpt --out cnn.msgpack
  python -m distributed_mnist_bnns_tpu_torch.cli train --model xnor-resnet18 \
      --dataset cifar10 --augment --backend pallas_xnor --checkpoint-dir ckpt
  python -m distributed_mnist_bnns_tpu_torch.cli export --model xnor-resnet18 \
      --dataset cifar10 --checkpoint-dir ckpt --out r18.msgpack
  python -m distributed_mnist_bnns_tpu_torch.cli infer --artifact r18.msgpack \
      --dataset cifar10
  python -m distributed_mnist_bnns_tpu_torch.cli serve --artifact r18.msgpack \
      --input-shape 32 32 3
  python -m distributed_mnist_bnns_tpu_torch.cli train --model xnor-resnet50 \
      --dataset imagenet --data-dir /data --stream --augment
  python -m distributed_mnist_bnns_tpu_torch.cli eval --checkpoint-dir ckpt
  python -m distributed_mnist_bnns_tpu_torch.cli export --checkpoint-dir ckpt \
      --out m.msgpack
  python -m distributed_mnist_bnns_tpu_torch.cli export --out m.msgpack
  python -m distributed_mnist_bnns_tpu_torch.cli infer --artifact m.msgpack
  python -m distributed_mnist_bnns_tpu_torch.cli serve --artifact m.msgpack
  python -m distributed_mnist_bnns_tpu_torch.cli lm --export lm.msgpack
  python -m distributed_mnist_bnns_tpu_torch.cli lm --steps 200 --export lm.msgpack
  python -m distributed_mnist_bnns_tpu_torch.cli serve --lm --artifact lm.msgpack
  python -m distributed_mnist_bnns_tpu_torch.cli serve --lm --artifact lm.msgpack \
      --spec-decode 4 --prefix-cache
  python -m distributed_mnist_bnns_tpu_torch.cli lm --load lm.msgpack --sample 32
  python -m distributed_mnist_bnns_tpu_torch.cli lm --steps 200 --ring \
      --sample 32 --temperature 0
  python -m distributed_mnist_bnns_tpu_torch.cli export --model bnn-vit-small \
      --checkpoint-dir ckpt --out vit.msgpack
  python -m distributed_mnist_bnns_tpu_torch.cli train --telemetry-dir tel \
      --trace --profile-steps 10:20
  python -m distributed_mnist_bnns_tpu_torch.cli serve --artifact m.msgpack \
      --telemetry-dir tel --trace --costs
  python -m distributed_mnist_bnns_tpu_torch.cli telemetry tel
  python -m distributed_mnist_bnns_tpu_torch.cli trace tel --export trace.json
  python -m distributed_mnist_bnns_tpu_torch.cli profile tel/profile

``train`` trains a registered model (``models.list_models()``: the
bnn-mlp family, ``fp32-mlp-large``, ``convnet``, ``deep-cnn``,
``bnn-cnn``, the bnn-vit family, ``qnn-mlp-large``, ``bnn-moe-mlp``, the
xnor-resnet family; ``train.Trainer``) on ``--dataset`` mnist, cifar10
or imagenet (``data.load_dataset``; synthetic data of the dataset's
shape when no files are found; ``--norm`` the dataset's statistics by
default; ``--image-size`` imagenet's resolution; ``--stream`` trains on
an on-disk ImageNet decoded per batch, ``Trainer.fit_stream``);
``--augment`` crops and flips each batch on the device inside the step;
``--precision bf16`` computes in bf16 over fp32
parameters where the model takes a dtype) and prints its final
metrics as one JSON line; with ``--dp N`` (or ``auto``: one rank a card)
it starts N ranks itself, over NCCL on the cards or over gloo with
``--device cpu``, and ``--grad-compress sign|sign_ef`` exchanges 1-bit
gradients (``--dp-hosts``: in two levels). ``--tp N`` shards the bnn-mlp
and bnn-vit models Megatron-style over N ranks and ``--pp N`` pipelines a
transformer's blocks over N (``--pp-microbatches``, ``--pp-remat``);
either times ``--dp`` ranks in all (``eval`` takes them too), with
``--scan-steps`` and ``--device-data`` as without them (captured over
NCCL). ``--xnor-scale`` turns on the XNOR-Net alpha in the models that
take it (the transformer families). ``--chaos SPEC`` (or ``JG_CHAOS``)
injects scripted faults (``resilience/chaos``); ``--elastic`` runs the
``--dp`` ranks under ``resilience.run_elastic``: a chaos
``worker_lost``/``worker_restore`` respawns them at the new world from
the newest verified checkpoint generation. A ``train`` started with the
``JG_MH_*`` environment (``resilience.run_elastic_multihost``) is one
host of a multihost world, its 1-bit exchange over TCP
(``parallel/hostcomm``). Checkpoints are the JAX
package's (``checkpoint.msgpack``, digests and generations in
``checkpoint_meta.json``); ``--resume`` continues the newest verified one,
at the step where a graceful stop left it: SIGTERM (passed on to the
ranks of a ``--dp`` run) or SIGINT writes a checkpoint and exits with 75
(``--no-preemption``: the signals kill as usual). ``--nodes N --node-rank
R --coordinator HOST:PORT`` runs node R of N: its ``--dp / N`` ranks (or
one a card with ``--dp auto``) join the others at ``tcp://HOST:PORT``,
each try bounded by ``--init-timeout`` and retried ``--init-retries``
times. ``--timing-csv PREFIX`` writes each batch's host dispatch time and
each epoch's time; ``--results`` a CSV (and HTML plot) a row an epoch.
``eval`` evaluates the
latest (``--best``: the best) checkpoint of a ``train --checkpoint-dir``
run (with the optimizer flags of the run). ``export`` freezes
a ``bnn-mlp``, ``bnn-cnn``, ``bnn-vit``, ``qnn-mlp``, ``bnn-moe-mlp`` or
``xnor-resnet`` model (a trained checkpoint with ``--checkpoint-dir``, a
seeded init, or weights carried across from the JAX package with
``--jax-variables``) into the packed artifact (the JAX package's
msgpack; a conv artifact at ``--dataset``'s resolution); ``infer``
evaluates an artifact on ``--dataset``'s test split (synthetic data when
no files are found); ``serve`` runs the HTTP
server (``--lm``: the continuous-batching LM server, with
``--prefix-cache`` and ``--spec-decode K``; ``--chaos``: the serving
faults ``infer_error`` and ``infer_slow``); ``lm --export`` freezes a
BinarizedLM (seeded init, or JAX weights with ``--jax-variables``) into
a packed LM artifact, ``lm --steps N`` first trains it N steps
(``examples/lm_demo.py::run``; flash attention by default; ``--ring``:
sequence-parallel ring attention; ``--sample N``: N tokens drawn after
training) and exports the trained model, and ``lm --load --sample``
generates from one at ``--temperature`` (0.8; 0 is greedy), drawing from
a generator seeded with ``--seed``. ``--device`` defaults to ``cuda`` and
never falls back to the CPU: pass ``--device cpu`` to run there.

Telemetry (``obs/``, the JAX package's flags and readers): ``train`` and
``eval`` take ``--telemetry-dir`` (JSONL events and heartbeats),
``--trace`` (span trees in that log), ``--profile-dir`` (a
``torch.profiler`` capture of the first epoch's early steps) and
``--profile-steps A:B`` (a capture of cumulative steps A to B, into
``--profile-dir`` or ``<telemetry-dir>/profile``); ``serve`` (and
``serve --lm``) takes ``--telemetry-dir``, ``--trace``, ``--costs`` (the
per-program cost ledger in /healthz) and ``--events-max-bytes``.
``telemetry LOG`` summarizes a run's event log (a table, or ``--json``),
``trace LOG...`` reports the p99 tail attribution of its span trees (or
per-kind totals for a training run) and ``--export``s Chrome-trace JSON
for Perfetto, ``profile DIR`` summarizes a capture: top ops, the card's
kernels, the package's kernels inside ``jg_step`` regions.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

log = logging.getLogger(__name__)

#: the models ``export`` freezes
FREEZABLE = ("bnn-mlp-large", "bnn-mlp-small", "bnn-cnn", "bnn-vit-tiny",
             "bnn-vit-small", "qnn-mlp-large", "bnn-moe-mlp",
             "xnor-resnet18", "xnor-resnet50")
DATASETS = ("mnist", "cifar10", "imagenet")
NORMS = ("mnist", "cifar", "imagenet", "half", "none")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="distributed_mnist_bnns_tpu_torch")
    p.add_argument("--log-level", default="INFO")
    sub = p.add_subparsers(dest="cmd", required=True)

    for cmd, what in (("train", "train a registered model"),
                      ("eval", "evaluate a train run's checkpoint")):
        _train_flags(sub.add_parser(cmd, help=what))

    x = sub.add_parser(
        "export", help="freeze a bnn-mlp, bnn-cnn, bnn-vit, qnn-mlp, "
                       "bnn-moe-mlp or xnor-resnet model into a packed "
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
    x.add_argument("--out", default="model_packed.msgpack")
    x.add_argument("--dataset", default="mnist", choices=list(DATASETS),
                   help="a conv artifact is frozen for this dataset's "
                        "resolution (xnor-resnet: cifar10 32x32, imagenet "
                        "--image-size)")
    x.add_argument("--image-size", type=int, default=224)

    inf = sub.add_parser(
        "infer", help="evaluate a packed artifact on a dataset's test split",
    )
    inf.add_argument("--artifact", required=True)
    inf.add_argument("--device", default="cuda")
    inf.add_argument("--batch-size", type=int, default=64)
    _data_flags(inf)
    inf.add_argument("--seed", type=int, default=0,
                     help="seed of the synthetic fallback data")

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
    sv.add_argument("--prefix-cache", action="store_true",
                    help="--lm: copy-on-write prompt-prefix sharing over "
                         "the paged KV pool: full pages of a cached prefix "
                         "fork refcounted into a new sequence, which "
                         "prefills only its suffix; finished sequences "
                         "publish their pages, LRU-evicted under pool "
                         "pressure")
    sv.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="--lm: self-speculative decoding: per round K-1 "
                         "tokens drafted through the packed decode call "
                         "and the K-token window verified in one call "
                         "through the same packed weights; greedy tokens "
                         "equal the verifier alone's. 0 = off")
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
    sv.add_argument("--telemetry-dir", default=None,
                    help="JSONL request/shed/breaker/drain events here; "
                         "read back with `telemetry`")
    sv.add_argument("--trace", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="per-request span trees in the event log, "
                         "joined to the client's x-jg-trace header; read "
                         "back with `trace`. Default: the JG_TRACE env "
                         "var; needs --telemetry-dir")
    sv.add_argument("--costs", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="the per-program cost ledger (counted flops, "
                         "bytes, peak memory) and measured MFU in "
                         "/healthz. Default: the JG_COSTS env var")
    sv.add_argument("--events-max-bytes", type=int, default=None,
                    help="size-rotate the events.jsonl past this many "
                         "bytes (default: JG_EVENTS_MAX_BYTES, else "
                         "unbounded)")
    sv.add_argument("--chaos", default=None, metavar="SPEC",
                    help="serving fault injection (resilience/chaos): "
                         "e.g. 'infer_error@step=4,times=3;"
                         "infer_slow@p=0.1,delay_s=0.5'. Default: the "
                         "JG_CHAOS env var")
    sv.add_argument("--seed", type=int, default=0,
                    help="seeds the chaos rules' draws")
    sv.add_argument("--input-shape", type=int, nargs="+",
                    default=[28, 28, 1])

    lm = sub.add_parser(
        "lm", help="train (--ring: sequence-parallel ring attention) and/or "
                   "export a packed BinarizedLM artifact, or sample from "
                   "one",
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
                    help="seed of the torch.Generators of the weights and "
                         "of the sampling")
    lm.add_argument("--load", default=None, metavar="PATH",
                    help="load a packed LM artifact and generate --sample "
                         "tokens through the KV-cache decoder")
    lm.add_argument("--sample", type=int, default=0,
                    help="with --steps: draw N tokens from the trained "
                         "model (sliding window); with --load: generate N "
                         "(0: 64)")
    lm.add_argument("--temperature", type=float, default=0.8,
                    help="sampling temperature (0 = greedy); the draws "
                         "come from a torch.Generator seeded from --seed")
    lm.add_argument("--ring", action="store_true",
                    help="with --steps: sequence-parallel causal ring "
                         "attention, one rank per visible card (two gloo "
                         "processes with --device cpu)")
    lm.add_argument("--prompt", default="\n",
                    help="with --load: text prompt (UTF-8 bytes mod vocab)")
    lm.add_argument("--pp", type=int, default=1,
                    help="with --steps: pipeline the block stack over N "
                         "ranks (one a card; gloo processes with --device "
                         "cpu)")
    lm.add_argument("--device", default="cuda")

    tm = sub.add_parser(
        "telemetry", help="summarize a run's telemetry event log")
    tm.add_argument("log", help="an events.jsonl, or the telemetry "
                                "directory holding one")
    tm.add_argument("--json", action="store_true",
                    help="one JSON object instead of the table")
    tc = sub.add_parser(
        "trace", help="a traced run's span trees: the p99 tail "
                      "attribution, or Chrome-trace JSON for Perfetto")
    tc.add_argument("log", nargs="+",
                    help="events.jsonl files or telemetry directories "
                         "(several: request trees stitched across the "
                         "x-jg-trace hop)")
    tc.add_argument("--export", default=None, metavar="OUT",
                    help="write the Chrome-trace-event JSON here ('-' = "
                         "stdout); open in https://ui.perfetto.dev")
    tc.add_argument("--tail-pct", type=float, default=99.0)
    tc.add_argument("--json", action="store_true")
    pf = sub.add_parser(
        "profile", help="summarize a torch.profiler capture directory")
    pf.add_argument("dir", help="the capture directory (/admin/profile's "
                                "`dir`, or --profile-dir)")
    pf.add_argument("--top", type=int, default=15)
    pf.add_argument("--json", action="store_true")
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
    sp.add_argument("--scan-steps", type=int, default=1,
                    help="train N steps a dispatch: on a card one CUDA "
                         "graph of N steps, captured once and replayed "
                         "(with --dp, --tp or --pp, the collectives "
                         "inside: NCCL)")
    sp.add_argument("--device-data", action="store_true",
                    help="keep the dataset on the device: each epoch one "
                         "gather, then graph replays of --scan-steps (or "
                         "64) steps and one host sync; eval on the device "
                         "(with --dp each rank gathers its columns; "
                         "--dp-mode fsdp streams; no --grad-compress)")
    sp.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per optimizer step (activation-"
                         "memory saver; batch-size must divide evenly)")
    sp.add_argument("--remat", action="store_true",
                    help="recompute the forward's activations in the "
                         "backward (activation checkpoint)")
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
    sp.add_argument("--xnor-scale", action="store_true",
                    help="XNOR-Net per-channel alpha rescaling on "
                         "binarized GEMMs (models that support it: the "
                         "transformer families)")
    sp.add_argument("--dropout", type=float, default=None,
                    help="dropout rate for the transformer families "
                         "(bnn-vit*; the MLP topologies carry their "
                         "reference-fixed rates); composes with --pp")
    sp.add_argument("--loss", default="ce", choices=list(LOSSES))
    sp.add_argument("--label-smoothing", type=float, default=0.0,
                    help="uniform target mixing for the ce loss")
    _data_flags(sp)
    sp.add_argument("--augment", action="store_true",
                    help="device-side random crop + flip of each batch "
                         "inside the train step (the CIFAR recipe; "
                         "ops/augment)")
    sp.add_argument("--stream", action="store_true",
                    help="train --dataset imagenet on the streaming "
                         "pipeline (decoded per batch, never materialized; "
                         "Trainer.fit_stream), evaluated on the "
                         "materialized val subset")
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--best", action="store_true",
                    help="eval: the best checkpoint instead of the latest")
    sp.add_argument("--save-all", action="store_true",
                    help="keep a checkpoint_epoch_N copy of every epoch")
    sp.add_argument("--async-checkpoint", action="store_true",
                    help="write checkpoints on a background thread")
    sp.add_argument("--checkpoint-keep", type=int, default=3,
                    help="checkpoint generations kept for corruption "
                         "rollback (digest-verified on resume)")
    sp.add_argument("--resume", action="store_true",
                    help="continue from the newest verified checkpoint")
    sp.add_argument("--chaos", default=None, metavar="SPEC",
                    help="fault-injection spec (resilience/chaos): "
                         "';'-separated kind@k=v entries, e.g. "
                         "'step_fault@step=5;ckpt_corrupt@epoch=1;"
                         "preempt@step=12'. Kinds: step_fault, data_io, "
                         "preempt, slow_host, ckpt_corrupt, ckpt_truncate, "
                         "infer_slow, infer_error, worker_lost, "
                         "worker_restore (the last two need --elastic), "
                         "host_lost, host_restore (the multihost runtime). "
                         "Default: the JG_CHAOS env var")
    sp.add_argument("--elastic", action="store_true",
                    help="elastic data-parallel membership: a chaos "
                         "worker_lost/worker_restore respawns the --dp "
                         "ranks at the new world, state re-placed from the "
                         "newest digest-verified checkpoint generation "
                         "instead of restarting the job; a checkpoint of "
                         "another world resumes. Needs --checkpoint-dir; "
                         "DP only (TP/PP/--device-data refused)")
    sp.add_argument("--no-preemption", action="store_true",
                    help="do not turn SIGTERM/SIGINT into a graceful stop "
                         "+ mid-epoch checkpoint + exit 75")
    sp.add_argument("--results", default=None,
                    help="per-epoch results CSV (and an HTML plot)")
    sp.add_argument("--timing-csv", default=None,
                    help="prefix of the per-batch / per-epoch timing CSVs")
    sp.add_argument("--log-file", default=None,
                    help="also log (DEBUG) to this file, from rank 0")
    sp.add_argument("--device", default="cuda")
    sp.add_argument("--telemetry-dir", default=None,
                    help="structured run telemetry here: JSONL events "
                         "(manifest/step/epoch/checkpoint), per-rank "
                         "heartbeats; read back with `telemetry`")
    sp.add_argument("--trace", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="step/checkpoint/restore spans in the event log "
                         "(`trace`). Default: the JG_TRACE env var; needs "
                         "--telemetry-dir")
    sp.add_argument("--profile-dir", default=None,
                    help="a torch.profiler capture of the first trained "
                         "epoch's early steps here")
    sp.add_argument("--profile-steps", default=None, metavar="A:B",
                    help="capture cumulative optimizer steps A to B into "
                         "--profile-dir (or <telemetry-dir>/profile); "
                         "summarize with `profile`")
    # parallelism
    sp.add_argument("--dp", default="1",
                    help="'auto' = all devices, or an integer")
    sp.add_argument("--dp-mode", default="gspmd",
                    choices=["gspmd", "fsdp"],
                    help="fsdp: each rank holds its shard of every "
                         "parameter and of the optimizer state (ZeRO: "
                         "gradients reduce-scattered, shards all-"
                         "gathered); with --grad-compress the 1-bit "
                         "exchange runs the optimizer on segments")
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
    # multi-node rendezvous (the reference's -n / -nr and master address)
    sp.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width: Megatron column/row "
                         "shards over a 'model' axis of ranks (the "
                         "bnn-mlp and bnn-vit families; the ViT's heads "
                         "split over the ranks); with --dp a (dp x tp) "
                         "mesh")
    sp.add_argument("--pp", type=int, default=1,
                    help="pipeline stages: GPipe the transformer block "
                         "stack over N ranks (bnn-vit models; depth %% N "
                         "== 0); with --dp a (dp x pp) mesh")
    sp.add_argument("--pp-microbatches", type=int, default=0,
                    help="microbatches per pipelined step (0 = one per "
                         "stage)")
    sp.add_argument("--pp-remat", action="store_true",
                    help="checkpoint each pipeline stage (recompute in "
                         "backward)")
    sp.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="the ranks' transport (default: nccl on the "
                         "cards, one rank a card; gloo with --device cpu). "
                         "gloo on the cards lets ranks share a card")
    sp.add_argument("--nodes", type=int, default=1)
    sp.add_argument("--node-rank", type=int, default=0)
    sp.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous store")
    sp.add_argument("--init-timeout", type=float, default=60.0,
                    help="seconds a rendezvous try may take")
    sp.add_argument("--init-retries", type=int, default=3,
                    help="retries of a failed rendezvous (unreachable or "
                         "timed out; a rank collision fails at once)")


def _data_flags(sp: argparse.ArgumentParser) -> None:
    """The dataset flags of ``train``, ``eval``, ``export`` and ``infer``
    (the JAX CLI's)."""
    sp.add_argument("--dataset", default="mnist", choices=list(DATASETS))
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--norm", default=None, choices=list(NORMS),
                    help="default: the dataset's own statistics")
    sp.add_argument("--image-size", type=int, default=224,
                    help="imagenet decode / synthetic resolution")
    sp.add_argument("--synthetic-sizes", type=int, nargs=2, default=None,
                    metavar=("TRAIN", "TEST"),
                    help="sizes of the synthetic fallback dataset (default: "
                         "the loader's)")


def _check_norm(args) -> None:
    from .data import DATASET_NORM

    if args.norm not in (None, "half", "none", DATASET_NORM[args.dataset]):
        raise SystemExit(f"--norm {args.norm} is not valid for --dataset "
                         f"{args.dataset}")


def _mp(args) -> int:
    """Ranks a data row holds: ``--tp`` or ``--pp`` (1 without)."""
    return max(args.tp, 1) * max(args.pp, 1)


def _dist_backend(args) -> str:
    """One rank a card over NCCL; on the CPU, gloo processes; gloo ranks
    sharing the cards only when ``--dist-backend gloo`` asks for it."""
    if args.dist_backend:
        return args.dist_backend
    return "gloo" if args.device == "cpu" else "nccl"


def _local_ranks(args) -> int:
    """The ranks this node starts: ``--dp`` (times ``--tp`` or ``--pp``:
    the whole world) over ``--nodes``; 'auto' is one a card (``--device
    cpu``: as many gloo processes as there are cards, at least one)."""
    if args.dp == "auto":
        import torch

        return max(torch.cuda.device_count(), _mp(args))
    world = int(args.dp) * _mp(args)
    if world % args.nodes:
        raise SystemExit(f"--dp {world} is not a multiple of --nodes "
                         f"{args.nodes}")
    return world // args.nodes


def _model_kwargs(args, num_classes: int = 10) -> dict:
    """The model kwargs of the flags, by the JAX CLI's rule
    (``_make_trainer``): ``infl_ratio`` to the bnn-mlp family only (the
    other MLPs keep their widths), ``num_classes`` when the dataset's is
    not 10, ``stochastic`` and ``scale`` when given, and ``--dropout``
    as ``dropout``, the transformer families' rate. The other models
    keep their reference-fixed rates: a ``--dropout`` for one of them
    exits with a message."""
    mk = {}
    if args.model.startswith("bnn-mlp"):
        mk["infl_ratio"] = args.infl_ratio
    if num_classes != 10:
        mk["num_classes"] = num_classes
    if getattr(args, "stochastic", False):
        mk["stochastic"] = True
    if getattr(args, "xnor_scale", False):
        mk["scale"] = True
    if getattr(args, "dropout", None) is not None:
        if "vit" not in args.model:
            raise SystemExit(
                f"--dropout sets the transformer families' rate (bnn-vit*, "
                f"fp32-vit*); {args.model!r} keeps its reference-fixed "
                "rate")
        mk["dropout"] = args.dropout
    return mk


def _trainer(args, data_parallel=None, device=None, resume=None):
    from .train import TrainConfig, Trainer

    input_shape, num_classes = _data_spec(args)
    return Trainer(TrainConfig(
        chaos=args.chaos, elastic=args.elastic,
        data_parallel=data_parallel, dp_mode=args.dp_mode,
        grad_compress=args.grad_compress, dp_hosts=args.dp_hosts,
        compress_bucket_size=args.compress_bucket_size,
        compress_chunks=args.compress_chunks,
        model=args.model, model_kwargs=_model_kwargs(args, num_classes),
        precision=args.precision, epochs=args.epochs,
        batch_size=args.batch_size, optimizer=args.optimizer,
        learning_rate=args.lr, lr_schedule=args.lr_schedule,
        warmup_epochs=args.warmup_epochs, clip_grad_norm=args.clip_grad_norm,
        seed=args.seed, log_interval=args.log_interval, loss=args.loss,
        label_smoothing=args.label_smoothing, backend=args.backend,
        scan_steps=args.scan_steps, device_data=args.device_data,
        grad_accum=args.grad_accum, remat=args.remat, augment=args.augment,
        checkpoint_dir=args.checkpoint_dir, save_all_epochs=args.save_all,
        async_checkpoint=args.async_checkpoint,
        checkpoint_keep=args.checkpoint_keep,
        resume=args.resume if resume is None else resume,
        tensor_parallel=args.tp, pipeline_parallel=args.pp,
        pp_microbatches=args.pp_microbatches, pp_remat=args.pp_remat,
        handle_preemption=not args.no_preemption,
        results_path=args.results, timing_csv_prefix=args.timing_csv,
        device=args.device if device is None else device,
        telemetry_dir=args.telemetry_dir, trace=args.trace,
        profile_dir=args.profile_dir, profile_step_window=args.profile_steps,
    ), input_shape=input_shape)


def _load_kwargs(args) -> dict:
    """``load_dataset``'s keyword arguments from the dataset flags."""
    kw = {}
    if args.norm is not None:
        kw["norm"] = args.norm
    if args.synthetic_sizes is not None:
        kw["synthetic_sizes"] = tuple(args.synthetic_sizes)
    if args.dataset == "imagenet":
        kw["image_size"] = args.image_size
    return kw


def _train_data(args):
    """The run's dataset (``--dataset``), loaded once a process. The
    synthetic fallback is seed 0's whatever --seed says, as in the JAX
    CLI, so train, eval and infer see the same data."""
    data = getattr(args, "_data", None)
    if data is None:
        from .data import load_dataset

        data = args._data = load_dataset(args.dataset, args.data_dir,
                                         **_load_kwargs(args))
    return data


def _stream_data(args):
    """``train --stream``: the on-disk ImageNet train split as a stream
    and the materialized val subset (2,048 images, indexed against the
    train split's wnids) as the eval data, or None without a val split;
    opened once a process. Exits 2 without an on-disk layout, as the JAX
    CLI does."""
    held = getattr(args, "_stream", None)
    if held is not None:
        return held
    import numpy as np

    from .data import ImageClassData, open_imagenet_stream

    if args.dataset != "imagenet":
        log.error("--stream is for `train --dataset imagenet`")
        raise SystemExit(2)
    norm_kw = {"norm": args.norm} if args.norm else {}
    stream = open_imagenet_stream(args.data_dir, "train",
                                  image_size=args.image_size, **norm_kw)
    if stream is None:
        log.error("--stream needs an on-disk ImageNet layout under %s "
                  "(train/<wnid>/ dirs or <wnid>.tar files)", args.data_dir)
        raise SystemExit(2)
    val = open_imagenet_stream(args.data_dir, "val",
                               image_size=args.image_size,
                               wnids=stream.index.wnids, **norm_kw)
    eval_data = None
    if val is None:
        log.warning("no val/ split under %s: training without eval (no "
                    "best-checkpoint tracking)", args.data_dir)
    else:
        vx, vy = val.materialize(2048)
        eval_data = ImageClassData(
            np.zeros((1, *vx.shape[1:]), np.float32), np.zeros(1, np.int32),
            vx, vy, source="imagenet", name="imagenet",
            n_classes=stream.n_classes)
    args._stream = (stream, eval_data)
    return args._stream


def _data_spec(args):
    """(one example's input shape, the label space's size) of the run's
    data: the trainer's input shape and the model's ``num_classes``."""
    if getattr(args, "stream", False):
        stream, _ = _stream_data(args)
        return (args.image_size, args.image_size, 3), stream.n_classes
    data = _train_data(args)
    return data.input_shape, getattr(data, "n_classes", 10)


def _fit(args, data_parallel=None, device=None) -> dict:
    """The run's final row, or ``{"preempted": exit code}`` after a
    graceful stop (the JAX ``_fit_resumable``)."""
    from .resilience import Preempted

    trainer = _trainer(args, data_parallel, device)
    try:
        return _fit_row(args, trainer)
    except Preempted as e:
        log.warning("%s; state checkpointed: rerun with --resume to "
                    "continue (exit %d)", e, e.exit_code)
        return {"preempted": e.exit_code, "step": trainer.step}


def _fit_row(args, trainer) -> dict:
    """Fit ``trainer`` on the run's data (``--stream``: the stream); its
    final row."""
    if getattr(args, "stream", False):
        stream, eval_data = _stream_data(args)
        history = trainer.fit_stream(stream, eval_data=eval_data)
        source = "imagenet-stream"
    else:
        data = _train_data(args)
        history = trainer.fit(data)
        source = data.source
    if not history:   # resumed a finished run
        return {"model": args.model, "total_steps": trainer.step,
                "best_acc": trainer.best_acc}
    return {
        "model": args.model, "device": str(trainer.device),
        "data_source": source, **history[-1],
        "total_steps": trainer.step, "best_acc": trainer.best_acc,
        "checkpoint_dir": args.checkpoint_dir,
        "data_parallel": trainer.dp_n, "grad_compress": args.grad_compress,
        "comm_bytes_per_step": trainer.comm_bytes() / max(trainer.step, 1),
    }


def _setup_logging(args, rank: int = 0) -> None:
    """The console at ``--log-level`` (rank 0; WARNING on the others),
    and with ``--log-file`` DEBUG to that file from rank 0
    (``utils.setup_logging``)."""
    from .utils import setup_logging

    if args.log_file and rank == 0:
        setup_logging(args.log_file, console_level=args.log_level,
                      primary_only=False)
        return
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    logging.basicConfig(
        level=args.log_level if rank == 0 else "WARNING",
        format=f"%(asctime)s %(levelname)s rank {rank} %(name)s: "
               "%(message)s")


def _elastic_trainer(args, world):
    """``run_elastic``'s factory in a rank: the launch configuration
    (``world`` None), or the run resumed at ``world`` ranks."""
    _setup_logging(args, _rank_of_group())
    if world is None:
        return _trainer(args, data_parallel=int(args.dp))
    return _trainer(args, data_parallel=world, resume=True)


def _rank_of_group() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _train_elastic(args) -> dict:
    """``train --elastic``: the ``--dp`` ranks under
    ``resilience.run_elastic`` (a chaos membership change respawns them
    at the new world); a real signal still vacates with exit 75."""
    import functools

    from .obs import Telemetry
    from .resilience import Preempted, RetryPolicy, run_elastic

    if _mp(args) > 1 or args.device_data or args.dp == "auto" or (
            args.nodes > 1 or args.coordinator is not None):
        raise SystemExit("--elastic runs data parallelism of an integer "
                         "--dp on one node (no --tp/--pp/--device-data)")
    sup = (Telemetry(args.telemetry_dir, heartbeat=False)
           if args.telemetry_dir else None)
    try:
        return run_elastic(
            functools.partial(_elastic_trainer, args),
            functools.partial(_fit_row, args), world=int(args.dp),
            backend=_dist_backend(args),
            device="cpu" if args.device == "cpu" else "cuda",
            policy=RetryPolicy(seed=args.seed), telemetry=sup)
    except Preempted as e:
        log.warning("%s; state checkpointed: rerun with --resume to "
                    "continue (exit %d)", e, e.exit_code)
        return {"preempted": e.exit_code, "step": e.step}
    finally:
        if sup is not None:
            sup.close()


def _train_rank(rank: int, world: int, device, args) -> dict:
    """One rank of ``train --dp`` (``--tp``, ``--pp``): the trainer on
    this rank's device."""
    _setup_logging(args, rank)
    return _fit(args, data_parallel=world // _mp(args), device=str(device))


def _eval_rank(rank: int, world: int, device, args) -> dict:
    """One rank of ``eval --tp`` / ``--pp``: the sharded trainer restored
    and evaluated (the forward is collective)."""
    _setup_logging(args, rank)
    return _eval_row(args, data_parallel=world // _mp(args),
                     device=str(device))


def _train(args) -> int:
    _check_norm(args)
    if args.stream:
        _stream_data(args)   # exits 2 here without an on-disk layout
        args._stream = None  # each process opens its own (threads inside)
    if args.grad_accum < 1 or args.batch_size % args.grad_accum:
        raise SystemExit(f"--batch-size {args.batch_size} not divisible by "
                         f"--grad-accum {args.grad_accum}")
    local = _local_ranks(args)
    multinode = args.nodes > 1 or args.coordinator is not None
    from .parallel.distributed import detect_multihost

    if args.elastic and detect_multihost() is None:
        # a multihost rank (JG_MH_*) is supervised by its parent
        # (resilience.run_elastic_multihost): it fits alone, exit 75 on
        # a host loss or regrow
        row = _train_elastic(args)
    elif local <= 1 and not multinode and _mp(args) == 1:
        if args.log_file:
            _setup_logging(args)
        row = _fit(args)
    else:
        from .parallel import spawn

        rows = spawn(_train_rank, local, backend=_dist_backend(args),
                     device="cpu" if args.device == "cpu" else "cuda",
                     args=(args,), coordinator=args.coordinator,
                     nodes=args.nodes, node_rank=args.node_rank,
                     init_timeout=args.init_timeout,
                     init_retries=args.init_retries)
        row = rows[0]
    if "preempted" in row:
        return row["preempted"]
    if args.node_rank == 0:
        print(json.dumps(row))
    return 0


def _eval_row(args, data_parallel=None, device=None) -> dict:
    trainer = _trainer(args, data_parallel, device)
    meta = trainer.restore(args.checkpoint_dir, best=args.best)
    data = _train_data(args)
    metrics = trainer.evaluate(data)
    # fit() seals a training run's log; a standalone eval seals its own
    trainer.telemetry.emit("eval", **metrics)
    trainer.telemetry.close()
    return {
        "model": args.model, "device": str(trainer.device),
        "data_source": data.source, "checkpoint_epoch": meta.get("epoch"),
        "checkpoint_step": trainer.step, **metrics,
    }


def _eval(args) -> int:
    _check_norm(args)
    if not args.checkpoint_dir:
        raise SystemExit("eval requires --checkpoint-dir")
    if _mp(args) > 1:
        from .parallel import spawn

        rows = spawn(_eval_rank, _local_ranks(args),
                     backend=_dist_backend(args),
                     device="cpu" if args.device == "cpu" else "cuda",
                     args=(args,))
        print(json.dumps(rows[0]))
        return 0
    print(json.dumps(_eval_row(args)))
    return 0


def _export(args) -> int:
    import numpy as np
    import torch

    from .infer import export_packed
    from .models import get_model

    if args.checkpoint_dir and args.jax_variables:
        raise SystemExit("export: give at most one of --checkpoint-dir and "
                         "--jax-variables")
    side = args.image_size if args.dataset == "imagenet" else None
    input_shape = {"mnist": (28, 28, 1), "cifar10": (32, 32, 3),
                   "imagenet": (side, side, 3)}[args.dataset]
    num_classes = 1000 if args.dataset == "imagenet" else 10
    if args.checkpoint_dir:
        from .interop import params_from_jax
        from .train import load_checkpoint

        try:
            state = load_checkpoint(args.checkpoint_dir, best=args.best,
                                    model=args.model)["state"]
            if "resnet" in args.model:   # the label space the run had
                num_classes = int(np.asarray(
                    state["params"]["Dense_0"]["kernel"]).shape[1])
            model = params_from_jax(state, get_model(
                args.model, **_model_kwargs(args, num_classes)))
        except (ValueError, RuntimeError, KeyError) as e:
            raise SystemExit(f"export: {e}") from None
    elif args.jax_variables:
        from .interop import params_from_jax, variables_from_npz

        model = params_from_jax(variables_from_npz(args.jax_variables))
    else:
        gen = torch.Generator().manual_seed(args.seed)
        model = get_model(args.model, generator=gen,
                          **_model_kwargs(args, num_classes)).eval()
    info = export_packed(model, args.out, input_shape=input_shape)
    print(json.dumps({"artifact": args.out, **info}))
    return 0


def _infer(args) -> int:
    import numpy as np

    from .data import load_dataset
    from .infer import load_packed

    _check_norm(args)
    fn, info = load_packed(args.artifact, device=args.device)
    data = load_dataset(args.dataset, args.data_dir, seed=args.seed,
                        **_load_kwargs(args))
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
            telemetry_dir=args.telemetry_dir, trace=args.trace,
            costs=args.costs, events_max_bytes=args.events_max_bytes,
            chaos=args.chaos, seed=args.seed,
            prefix_cache=args.prefix_cache, spec_decode=args.spec_decode,
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
        telemetry_dir=args.telemetry_dir, trace=args.trace,
        costs=args.costs, events_max_bytes=args.events_max_bytes,
        chaos=args.chaos, seed=args.seed,
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
    if args.pp > 1 and not args.steps:
        raise SystemExit("lm: --pp pipelines the training; give --steps")
    if args.ring and not args.steps:
        raise SystemExit("lm: --ring is a training topology; give --steps")
    if args.sample < 0:
        raise SystemExit(f"lm: --sample must be >= 0, got {args.sample}")
    if args.temperature < 0:
        raise SystemExit(f"lm: --temperature must be >= 0 (0 = greedy), "
                         f"got {args.temperature}")
    if args.steps:
        from .examples.lm_demo import run

        res = run(
            steps=args.steps, seq_len=args.seq_len, batch=args.batch_size,
            vocab=args.vocab, embed_dim=args.embed_dim, depth=args.depth,
            num_heads=args.num_heads, mlp_ratio=args.mlp_ratio,
            scale=args.scale, lr=args.lr, seed=args.seed,
            attention=args.attention, corpus=args.corpus,
            export=args.export, device=args.device, pp=args.pp,
            ring=args.ring, sample=args.sample,
            temperature=args.temperature,
        )
        print(json.dumps({"steps": args.steps, "loss_history": res.history,
                          **({"sample": res.sample} if args.sample else {}),
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
    vocab = int(frozen["tok_embed"].shape[0])
    max_len = int(frozen["pos_embed"].shape[1])
    prompt = [b % vocab for b in args.prompt.encode("utf-8")]
    if len(prompt) >= max_len:
        raise SystemExit(f"lm: the prompt fills the window ({max_len})")
    # --sample keeps its training default of 0 ("none"): here 0 means a
    # demo length of 64, clamped to the artifact's window
    n = min(args.sample or 64, max_len - len(prompt))
    toks = generate(frozen, [prompt], n, temperature=args.temperature,
                    generator=torch.Generator().manual_seed(args.seed),
                    decoder=make_lm_decoder(frozen, device=args.device))
    out = [int(t) for t in toks[0, len(prompt):]]
    print(json.dumps({
        "tokens": out,
        "text": bytes(out).decode("utf-8", "replace") if vocab == 256 else None,
    }))
    return 0


def _events_path(given: str) -> str:
    import os

    from .obs.telemetry import EVENTS_FILE

    return os.path.join(given, EVENTS_FILE) if os.path.isdir(given) else given


def _telemetry(args) -> int:
    """The run log's summary: the table, or ``--json``."""
    from .obs import render_table, summarize

    path = _events_path(args.log)
    try:
        summary = summarize(path)
    except FileNotFoundError:
        print(f"no event log at {path}", file=sys.stderr)
        return 2
    print(json.dumps(summary) if args.json else render_table(summary))
    return 0


def _trace(args) -> int:
    """The span trees of one or more logs (several are stitched across
    the x-jg-trace hop, each process its own Perfetto lane): the tail
    attribution, or per-kind totals for a log without request roots."""
    import os

    from .obs.trace import (
        load_spans, render_attribution, span_kind_totals, stitch_spans,
        tail_attribution, to_chrome_trace,
    )

    groups = {}
    for given in args.log:
        path = _events_path(given)
        name = (os.path.basename(os.path.abspath(given))
                if os.path.isdir(given)
                else os.path.basename(os.path.dirname(os.path.abspath(path)))
                or given)
        try:
            groups[name] = (path, load_spans(path))
        except FileNotFoundError:
            print(f"no event log at {path}", file=sys.stderr)
            return 2
    if len(groups) > 1:
        stitched = stitch_spans(
            {name: spans for name, (_, spans) in groups.items()})
        spans, path = stitched["spans"], " + ".join(sorted(groups))
        print(f"stitched {stitched['joined']}/{stitched['replica_roots']} "
              f"replica request tree(s) across {len(groups)} log(s)",
              file=sys.stderr)
    else:
        (path, spans), = groups.values()
    if not spans:
        print(f"no span events in {path} — was the run traced? (--trace "
              "or JG_TRACE=1)", file=sys.stderr)
        return 2
    if args.export:
        if len(groups) > 1:
            chrome = {"traceEvents": [], "displayTimeUnit": "ms"}
            for pid, name in enumerate(sorted(groups)):
                rows = [s for s in spans
                        if (s.get("attrs") or {}).get("process") == name]
                chrome["traceEvents"] += to_chrome_trace(
                    rows, pid=pid, process_name=name)["traceEvents"]
        else:
            chrome = to_chrome_trace(spans, process_name=os.path.basename(
                os.path.dirname(os.path.abspath(path))))
        if args.export == "-":
            print(json.dumps(chrome))
            return 0
        with open(args.export, "w") as f:
            json.dump(chrome, f)
        print(f"wrote {len(chrome['traceEvents'])} trace events to "
              f"{args.export} (open in https://ui.perfetto.dev)",
              file=sys.stderr)
    report = tail_attribution(spans, pct=args.tail_pct)
    if report["n_requests"] == 0:
        totals = span_kind_totals(spans)
        if args.json:
            print(json.dumps({**report, "kind_totals": totals}))
            return 0
        print(f"no request spans in {path}; per-kind totals over "
              f"{len(spans)} span(s):")
        for kind, row in totals.items():
            print(f"  {kind:<16} x{row['count']:<6} "
                  f"{row['total_ms']:>12.3f} ms")
        return 0
    print(json.dumps(report) if args.json else render_attribution(report))
    return 0


def _profile(args) -> int:
    from .obs import render_capture_summary, summarize_capture

    try:
        summary = summarize_capture(args.dir, top=args.top)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2
    print(json.dumps(summary) if args.json
          else render_capture_summary(summary))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    return {"train": _train, "eval": _eval, "export": _export,
            "infer": _infer, "serve": _serve, "lm": _lm,
            "telemetry": _telemetry, "trace": _trace,
            "profile": _profile}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
