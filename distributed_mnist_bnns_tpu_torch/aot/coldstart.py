"""Cold-start worker: one boot, timed, as JSON (the JAX package's
``aot/coldstart.py``).

Run it as a process of its own: a cold start measured in a warm process
hides what it measures (imported modules, an initialised CUDA context,
loaded libraries). A caller runs it twice a target, once against an
empty store (cold: the boot builds its kernel libraries with ``nvcc``
and banks them) and once against the store the first run filled (warm:
the libraries are installed from it). Each run takes an empty kernel
build directory of its own (``JG_KERNEL_DIR=<dir>`` in its environment,
read by ``ops/_kernels.py``), so that a cold boot really runs ``nvcc``.

Three modes follow the three boot paths:

  serve   boot ``PackedInferenceServer``: ready, then the first response
  lm      boot ``LMServer``: ready, then the first streamed token
  train   build the ``Trainer`` (the AOT install included), then the
          first completed step

Output, the last line: one JSON object::

  {"mode": ..., "aot": ..., "aot_status": hit|miss|disabled,
   "boot_s": <entry -> ready>, "first_s": <entry -> first answer>,
   "compiles": <kernel_build + capture records of this boot>,
   "nvcc_s": {source: seconds of each nvcc run of the boot}}

and before it a ``{"coldstart_split": ...}`` line that splits the boot:
``interp_s`` (the interpreter's start, before this module ran),
``import_s`` (torch and the package), ``cuda_init_s`` (the CUDA
context; 0 on the CPU), ``libs_s`` (the kernel libraries' builds and
loads) and ``rest_s`` (the artifact, the model, the warm-up dispatch,
the HTTP front end).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T0 = time.perf_counter()


def _elapsed() -> float:
    return time.perf_counter() - _T0


def _process_age_s() -> float:
    """Seconds since this process started (Linux; 0 where /proc has no
    answer): the interpreter's start, before this module's first line."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_INTERP_S = _process_age_s()


def make_tiny_artifacts(work: str, *, lm_vocab: int = 32,
                        lm_max_len: int = 32, lm_embed: int = 32,
                        seed: int = 0):
    """Export the small classifier (``bnn-mlp-small``) and LM artifacts
    the cold-start runs boot from, with random weights from ``seed`` (a
    cold start's cost does not depend on the weights). Returns
    ``(classifier_path, lm_path)``."""
    import torch

    from ..infer import export_packed
    from ..models import get_model
    from ..models.transformer import BinarizedLM

    gen = torch.Generator().manual_seed(seed)
    cls_path = os.path.join(work, "cls.msgpack")
    model = get_model("bnn-mlp-small", backend="xla", generator=gen)
    export_packed(model.eval(), cls_path)
    lm_path = os.path.join(work, "lm.msgpack")
    lm = BinarizedLM(vocab=lm_vocab, max_len=lm_max_len,
                     embed_dim=lm_embed, depth=2, num_heads=2,
                     attention="xla", backend="xla", generator=gen)
    export_packed(lm.eval(), lm_path)
    return cls_path, lm_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", required=True, choices=["serve", "lm", "train"])
    p.add_argument("--artifact", default=None,
                   help="packed artifact (serve and lm modes)")
    p.add_argument("--store", required=True, help="AOT store root")
    p.add_argument("--no-aot", action="store_true",
                   help="measure the boot without the store")
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--page-size", type=int, default=8)
    p.add_argument("--model", default="bnn-mlp-small")
    p.add_argument("--backend", default=None,
                   help="train mode: the GEMM backend (pallas_xnor runs K1)")
    p.add_argument("--train-batch-size", type=int, default=32)
    args = p.parse_args(argv)
    aot = not args.no_aot
    t_import = _elapsed()
    import numpy as np
    import torch

    from ..analysis.guards import FENCED_KINDS
    from ..obs import get_tracker

    tracker = get_tracker()
    import_s = _elapsed() - t_import
    cuda_init_s = 0.0
    if torch.device(args.device).type == "cuda":
        t_cuda = _elapsed()
        torch.zeros(1, device=args.device)
        torch.cuda.synchronize()
        cuda_init_s = _elapsed() - t_cuda
    libs0 = tracker.compile_seconds
    builds0 = sum(tracker.kind_count(k) for k in FENCED_KINDS)
    out = {"mode": args.mode, "aot": aot}

    if args.mode == "serve":
        t_mod = _elapsed()
        from ..serve import PackedInferenceServer, ServeConfig

        import_s += _elapsed() - t_mod
        srv = PackedInferenceServer(ServeConfig(
            artifact=args.artifact, device=args.device, port=0,
            batch_size=args.batch_size, aot=aot, aot_dir=args.store))
        srv.start()
        out["boot_s"] = _elapsed()
        req = srv.engine.submit(
            np.zeros((1, 28, 28, 1), np.float32),
            time.monotonic() + 60)
        if isinstance(req, str) or not req.event.wait(60):
            print(json.dumps({**out, "error": f"no response ({req})"}))
            return 1
        out["first_s"] = _elapsed()
        out["aot_status"] = srv.aot_status
        out["nvcc_s"] = srv.aot_meta.get("nvcc_s", {})
        srv.request_stop()
        srv.drain_and_stop()

    elif args.mode == "lm":
        t_mod = _elapsed()
        from ..serve.lm import LMServeConfig, LMServer

        import_s += _elapsed() - t_mod
        srv = LMServer(LMServeConfig(
            artifact=args.artifact, device=args.device, port=0,
            slots=args.slots, page_size=args.page_size, aot=aot,
            aot_dir=args.store))
        srv.start()
        out["boot_s"] = _elapsed()
        req = srv.engine.submit(np.array([1, 2, 3], np.int32), 4,
                                time.monotonic() + 60)
        if isinstance(req, str):
            print(json.dumps({**out, "error": f"shed: {req}"}))
            return 1
        first = req.events.get(timeout=60)
        out["first_s"] = _elapsed()
        out["first_kind"] = first.get("kind")
        out["aot_status"] = srv.aot_status
        out["nvcc_s"] = srv.aot_meta.get("nvcc_s", {})
        while first.get("kind") != "done":
            first = req.events.get(timeout=60)
        srv.request_stop()
        srv.drain_and_stop()

    else:  # train
        t_mod = _elapsed()
        from ..train import TrainConfig, Trainer

        import_s += _elapsed() - t_mod
        trainer = Trainer(TrainConfig(
            model=args.model, batch_size=args.train_batch_size, epochs=1,
            backend=args.backend, device=args.device, log_interval=10 ** 9,
            handle_preemption=False, aot=aot, aot_dir=args.store,
        ))
        out["boot_s"] = _elapsed()
        rng = np.random.RandomState(0)
        images = torch.from_numpy(rng.rand(
            args.train_batch_size, 28, 28, 1).astype(np.float32))
        labels = torch.from_numpy(
            (np.arange(args.train_batch_size) % 10).astype(np.int64))
        loss, _ = trainer.train_step(trainer.model, trainer.optimizer,
                                     images.to(trainer.device),
                                     labels.to(trainer.device))
        float(loss)
        out["first_s"] = _elapsed()
        out["aot_status"] = trainer.aot_status
        out["nvcc_s"] = trainer.aot_nvcc_s

    out["compiles"] = sum(tracker.kind_count(k)
                          for k in FENCED_KINDS) - builds0
    # the tracker sums each source's nvcc seconds; a program's sources
    # build in parallel, so its build took the longest of them
    nvcc = out.get("nvcc_s") or {}
    libs_s = (tracker.compile_seconds - libs0 - sum(nvcc.values())
              + max(nvcc.values(), default=0.0))
    print(json.dumps({"coldstart_split": {
        "interp_s": round(_INTERP_S, 3), "import_s": round(import_s, 3),
        "cuda_init_s": round(cuda_init_s, 3), "libs_s": round(libs_s, 3),
        "rest_s": round(out["boot_s"] - import_s - cuda_init_s - libs_s,
                        3)}}), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
