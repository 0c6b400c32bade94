"""The rank side of the port's data-parallel parity tests.

``tests/test_torch_comm_compress.py`` and ``tests/test_torch_data_parallel.py``
start gloo ranks on the CPU with ``parallel.spawn`` and run the functions
here in each; the functions import only torch and the port (never JAX),
take their inputs as numpy arrays and return numpy arrays, which the
tests hold against the JAX package in the parent process.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from distributed_mnist_bnns_tpu_torch.interop import JaxFlatOrder
from distributed_mnist_bnns_tpu_torch.models.mlp import BnnMLP
from distributed_mnist_bnns_tpu_torch.ops import comm_compress as cc
from distributed_mnist_bnns_tpu_torch.parallel import make_groups
from distributed_mnist_bnns_tpu_torch.train import SignCompress

#: The small MLP of the transform cases (flax leaves of several sizes).
HIDDEN = (64, 32, 16)


def _np(t):
    return None if t is None else t.detach().cpu().numpy().copy()


def _wire(w):
    return {f"{lv}/{ph}": n for (lv, ph), n in sorted(w.items())}


def _plan(case):
    return cc.make_plan(case["n"], world=case["world"], mode=case["mode"],
                        bucket_size=case["bucket"], chunks=case["chunks"])


def _exchange_case(case, rank):
    plan = _plan(case)
    wire = cc.WireBytes()
    x = torch.from_numpy(case["x"][rank])
    kind = case["kind"]
    if kind == "exchange":
        e2 = case.get("e2")
        e2 = None if e2 is None else torch.from_numpy(e2[rank])
        out = cc.exchange(x, plan, group=dist.group.WORLD, e2=e2, wire=wire)
    elif kind == "rs":
        out = cc.reduce_scatter_compressed(x, plan, group=dist.group.WORLD,
                                           wire=wire)
    elif kind == "ag":
        out = cc.all_gather_compressed(x, plan, group=dist.group.WORLD,
                                       wire=wire)
    else:
        raise ValueError(kind)
    return {"out": [_np(t) for t in out], "wire": _wire(wire)}


def _hier_case(case, rank):
    hosts, local = case["hosts"], case["local"]
    hier = cc.make_hier_plan(case["n"], hosts=hosts, local=local,
                             mode=case["mode"], bucket_size=case["bucket"],
                             chunks=case["chunks"])
    groups = make_groups(hosts)
    wire = cc.WireBytes()
    e2 = case.get("e2")
    e2 = None if e2 is None else torch.from_numpy(e2[groups.host])
    out = cc.hier_exchange(torch.from_numpy(case["x"][rank]), hier,
                           host_group=groups.inter,
                           local_group=groups.local, e2=e2, wire=wire)
    return {"out": [_np(t) for t in out], "wire": _wire(wire)}


def transform_model() -> BnnMLP:
    return BnnMLP(hidden=HIDDEN, dropout_rate=0.0, backend="xla",
                  generator=torch.Generator().manual_seed(0))


def _transform_case(case, rank):
    """``SignCompress`` over the steps of ``case["grads"]`` (per step,
    {parameter name: (world, *shape) port-layout gradients}); per step
    the update of every parameter and this rank's error-feedback rows."""
    model = transform_model()
    hosts = case.get("hosts")
    group, local_group, world = dist.group.WORLD, None, case["world"]
    if hosts:
        groups = make_groups(hosts)
        group, local_group, world = groups.inter, groups.local, hosts
    wire = cc.WireBytes()
    tx = SignCompress(mode=case["mode"], order=JaxFlatOrder(model),
                      world=world, group=group, local_group=local_group,
                      bucket_size=case["bucket"], chunks=case["chunks"],
                      wire=wire)
    named = dict(model.named_parameters())
    params = list(named.values())
    steps = []
    for grads in case["grads"]:
        g = [torch.from_numpy(grads[name][rank]) for name in named]
        upd = tx(params, g)
        steps.append({
            "update": {name: _np(u) for name, u in zip(named, upd)},
            "state": {k: _np(v) for k, v in tx.state_dict().items()},
        })
    return {"steps": steps, "wire": _wire(wire)}


def comm_rank(rank, world, device, cases):
    """Every case of ``tests/test_torch_comm_compress.py`` in one rank."""
    torch.set_num_threads(1)
    out = []
    for case in cases:
        if case["kind"] == "hier":
            out.append(_hier_case(case, rank))
        elif case["kind"] == "transform":
            out.append(_transform_case(case, rank))
        else:
            out.append(_exchange_case(case, rank))
    return out


# -- trainer-level runs ------------------------------------------------------


def _state(model):
    return {k: _np(v) for k, v in model.state_dict().items()
            if "num_batches" not in k}


def _load_jax(model, variables):
    from distributed_mnist_bnns_tpu_torch.interop import params_from_jax

    params_from_jax(variables, model=model)


def _trainer(cfg_kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    cfg = dict(model="bnn-mlp-small", backend="xla", seed=0, device="cpu",
               log_interval=1)
    cfg.update(cfg_kw)
    return Trainer(TrainConfig(**cfg))


def _run_steps(step, model, optimizer, xs, ys, shard=None):
    """Each global batch's rows for this rank (``shard``, by default
    ``shard_batch``) through ``step``: per step (loss, accuracy, state
    after it) and the first step's gradients."""
    from distributed_mnist_bnns_tpu_torch.parallel import shard_batch

    shard = shard or shard_batch
    out, first_grads = [], None
    for s in range(len(xs)):
        x = torch.from_numpy(np.ascontiguousarray(shard(xs[s])))
        y = torch.from_numpy(np.ascontiguousarray(shard(ys[s])).astype(
            np.int64))
        loss, acc = step(model, optimizer, x, y)
        out.append((float(loss), float(acc), _state(model)))
        if s == 0:
            first_grads = {k: _np(p.grad) for k, p in
                           model.named_parameters() if p.grad is not None}
    return out, first_grads


def steps_rank(rank, world, device, jobs, xs, ys):
    """Each job ``(kind, trainer config, JAX variables)``: ``len(xs)``
    steps of one data-parallel step from the JAX variables. ``kind``
    "trainer" runs the step the Trainer builds for the config;
    "shardmap" ``make_shardmap_dp_train_step``."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        make_shardmap_dp_train_step,
    )

    torch.set_num_threads(1)
    out = []
    for kind, cfg_kw, variables in jobs:
        t = _trainer(cfg_kw)
        _load_jax(t.model, variables)
        if t.fsdp is not None:   # the shards follow the loaded weights
            t.fsdp.load_full()
        step, shard = t.train_step, t._shard
        if kind == "shardmap":
            step, shard = make_shardmap_dp_train_step(
                t.clamp_mask, loss_fn=t._loss_fn, wire=t.wire), None
        runs, first_grads = _run_steps(step, t.model, t.optimizer, xs, ys,
                                       shard)
        out.append({"runs": runs, "first_grads": first_grads,
                    "wire": _wire(t.wire), "jax_state": _full_state(t)})
    return out


def resume_run(rank, world, device, cfg_kw, ckpt_dir, xs, ys, split):
    """``len(xs)`` steps uninterrupted, against ``split`` steps, a
    checkpoint, a fresh trainer restored from it and the rest: both
    final states, optimizer moments and error feedback included."""
    torch.set_num_threads(1)

    def finish(t):
        ef = t.ef_rows()
        moments = {f"{i}/{k}": _np(v) for i, st in
                   t.optimizer.state_dict()["state"].items()
                   for k, v in st.items() if torch.is_tensor(v)}
        return {"state": _state(t.model), "step": t.step,
                "ef": {k: _np(v) for k, v in ef.items()}, "moments": moments}

    a = _trainer(cfg_kw)
    _run_steps(a.train_step, a.model, a.optimizer, xs, ys)
    b = _trainer(cfg_kw)
    _run_steps(b.train_step, b.model, b.optimizer, xs[:split], ys[:split])
    b.step = split
    b.save_checkpoint(ckpt_dir)
    c = _trainer(cfg_kw)
    c.restore(ckpt_dir)
    _run_steps(c.train_step, c.model, c.optimizer, xs[split:], ys[split:])
    c.step = len(xs)
    a.step = len(xs)
    return {"uninterrupted": finish(a), "resumed": finish(c),
            "files": sorted(os.listdir(ckpt_dir))}


def fit_run(rank, world, device, cfg_kw, sizes):
    """``Trainer.fit`` on the synthetic split: the history, the final
    state, the measured bytes and the plan's."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    torch.set_num_threads(1)
    t = _trainer(cfg_kw)
    data = load_mnist("/nonexistent-mnist-dir", synthetic_sizes=sizes, seed=0)
    before = t.evaluate(data)
    history = t.fit(data)
    plan = t.comm_plan
    ef = t.ef_rows()
    return {"before": before, "history": history, "state": _state(t.model),
            "steps": t.step, "loss_history": t.loss_history,
            "wire": _wire(t.wire),
            "plan": None if plan is None else plan.wire_bytes_per_step,
            "hier": None if t.hier_plan is None else (
                t.hier_plan.intra_bytes_per_step,
                t.hier_plan.inter_bytes_per_step),
            "ef_rows": {k: tuple(v.shape) for k, v in ef.items()},
            "optimizer": type(t.optimizer).__name__}


def raises_run(rank, world, device, cases):
    """Each config of ``cases`` built into a Trainer in this rank: the
    exception's type name and message (or None)."""
    torch.set_num_threads(1)
    out = []
    for cfg_kw in cases:
        try:
            _trainer(cfg_kw)
            out.append(None)
        except (ValueError, NotImplementedError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def jobs_rank(rank, world, device, jobs):
    """Each named job ``(name, function name, arguments)`` of this module
    in turn; {name: result}."""
    torch.set_num_threads(1)
    return {name: globals()[fn](rank, world, device, *args)
            for name, fn, args in jobs}


# -- resume and multi-node runs ------------------------------------------------


def _full_state(t):
    """Every tensor of a trainer's state in the flax layout, as numpy
    (params, batch stats, optimizer state, error-feedback rows)."""
    from distributed_mnist_bnns_tpu_torch.interop import train_state_to_jax
    from distributed_mnist_bnns_tpu_torch.utils.checkpoint import _to_host

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}" if prefix else k))
            return out
        return {prefix: np.asarray(tree)}

    return flat(_to_host(train_state_to_jax(t)))


def stop_after(t, steps):
    """Make ``t`` request a graceful stop once ``steps`` steps are done."""
    inner = t.train_step

    def step(*a):
        out = inner(*a)
        if t.step + 1 == steps:
            t.stop.request("stop requested by the test")
        return out

    t.train_step = step


def preempt_run(rank, world, device, cfg_kw, sizes, root, stop_rank,
                stop_steps):
    """Uninterrupted ``fit``, against a ``fit`` whose rank ``stop_rank``
    requests a stop after ``stop_steps`` steps (the run stops at the
    epoch boundary: the ``Preempted`` of every rank is recorded) and a
    resumed ``fit`` of the same checkpoint dir: both final states, and
    the checkpoint dir for the parent to read."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.resilience import Preempted
    from distributed_mnist_bnns_tpu_torch.utils.checkpoint import read_meta

    torch.set_num_threads(1)
    data = load_mnist("/nonexistent-mnist-dir", synthetic_sizes=sizes,
                      seed=0)
    a = _trainer(dict(cfg_kw, checkpoint_dir=f"{root}/uninterrupted"))
    a.fit(data, eval_every=0)
    ckpt = f"{root}/stopped"
    b = _trainer(dict(cfg_kw, checkpoint_dir=ckpt))
    if rank == stop_rank:
        stop_after(b, stop_steps)
    try:
        b.fit(data, eval_every=0)
        stopped = None
    except Preempted as e:
        stopped = {"epoch": e.epoch, "step": e.step}
    meta = read_meta(ckpt)
    c = _trainer(dict(cfg_kw, checkpoint_dir=ckpt, resume=True))
    history = c.fit(data, eval_every=0)
    return {"uninterrupted": _full_state(a), "resumed": _full_state(c),
            "stopped": stopped, "meta_at_stop": meta,
            "resumed_epochs": [h["epoch"] for h in history],
            "steps": (a.step, c.step), "ckpt": f"{root}/uninterrupted"}


def steps_state_run(rank, world, device, cfg_kw, hosts_list, steps):
    """For each ``dp_hosts`` of ``hosts_list`` (None: flat), a trainer of
    the world run ``steps`` steps of the seeded order: its final state."""
    from distributed_mnist_bnns_tpu_torch.data import (
        batch_iterator,
        load_mnist,
    )
    from distributed_mnist_bnns_tpu_torch.parallel import shard_batch

    torch.set_num_threads(1)
    data = load_mnist("/nonexistent-mnist-dir",
                      synthetic_sizes=(cfg_kw["batch_size"] * steps, 32),
                      seed=0)
    out = {}
    for hosts in hosts_list:
        t = _trainer(dict(cfg_kw, dp_hosts=hosts))
        for images, labels in batch_iterator(
                data.train_images, data.train_labels, cfg_kw["batch_size"],
                epoch=0, seed=cfg_kw.get("seed", 0)):
            x, y = t._to_device(shard_batch(images), shard_batch(labels))
            t.train_step(t.model, t.optimizer, x, y)
            t.step += 1
        out[str(hosts)] = _full_state(t)
    return out


# -- FSDP, remesh and the dispatch modes under data parallelism ---------------


def _generator_state(t):
    gen_fn = getattr(t.model, "train_generator", None)
    return None if gen_fn is None else (
        gen_fn(t.device).get_state().numpy().tobytes().hex())


def epoch_states_run(rank, world, device, jobs, sizes):
    """Each job ``(name, trainer config)``: one epoch of ``fit`` (no
    eval) on the synthetic split of ``sizes``; the full state in the
    flax layout, the generator, the per-step losses, the wire bytes and
    whether the epoch ran on the device."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    torch.set_num_threads(1)
    data = load_mnist("/nonexistent-mnist-dir", synthetic_sizes=sizes,
                      seed=0)
    out = {}
    for name, cfg_kw in jobs:
        t = _trainer(dict(cfg_kw, epochs=1))
        history = t.fit(data, eval_every=0)
        out[name] = {"state": _full_state(t), "gen": _generator_state(t),
                     "losses": t.loss_history, "steps": t.step,
                     "wire": _wire(t.wire), "plan": (
                         None if t.comm_plan is None
                         else t.comm_plan.wire_bytes_per_step),
                     "on_device": "dispatches" in history[-1],
                     "fsdp": t.fsdp is not None}
    return out


def capture_guard_run(rank, world, device):
    """``train.capture.check_capturable`` on this gloo group: the
    error's message, or None."""
    from distributed_mnist_bnns_tpu_torch.train.capture import (
        check_capturable,
    )

    try:
        check_capturable([dist.group.WORLD])
    except RuntimeError as e:
        return str(e)
    return None


def elastic_write_run(rank, world, device, cfg_kw, sizes, ckpt):
    """One epoch of ``fit`` with checkpoints under ``ckpt`` (the
    generation a smaller world resumes)."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    torch.set_num_threads(1)
    data = load_mnist("/nonexistent-mnist-dir", synthetic_sizes=sizes,
                      seed=0)
    t = _trainer(dict(cfg_kw, epochs=1, checkpoint_dir=ckpt))
    t.fit(data, eval_every=0)
    return {"ef": {k: _np(v) for k, v in t.ef_rows().items()}}


def elastic_resume_run(rank, world, device, cfg_kw, sizes, ckpt, epochs):
    """Resume ``ckpt`` (``resume=True``; ``cfg_kw`` says whether
    ``elastic``) and train to ``epochs``: the rows and moments just
    after the restore and the final full state, or the error the
    restore raised (type name, message)."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    torch.set_num_threads(1)
    data = load_mnist("/nonexistent-mnist-dir", synthetic_sizes=sizes,
                      seed=0)
    t = _trainer(dict(cfg_kw, epochs=epochs, checkpoint_dir=ckpt,
                      resume=True))
    try:
        start, _ = t.try_resume()
    except ValueError as e:
        return {"error": (type(e).__name__, str(e))}
    restored = _full_state(t)
    for epoch in range(start, epochs):
        t.train_epoch(data, epoch)
    return {"restored": restored, "final": _full_state(t),
            "steps": t.step, "losses": t.loss_history}


def shardmap_remat_run(rank, world, device, cfg_kw, xs, ys):
    """``make_shardmap_dp_train_step`` with and without ``remat`` from
    the same trainer state: both runs' states and losses."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        make_shardmap_dp_train_step,
    )

    torch.set_num_threads(1)
    out = {}
    for remat in (False, True):
        t = _trainer(cfg_kw)
        step = make_shardmap_dp_train_step(t.clamp_mask, loss_fn=t._loss_fn,
                                           remat=remat)
        runs, _ = _run_steps(step, t.model, t.optimizer, xs, ys)
        out[remat] = {"runs": runs, "gen": _generator_state(t)}
    return out


def topology_run(rank, world, device):
    from distributed_mnist_bnns_tpu_torch.parallel import mesh_topology

    return mesh_topology()


def _native_gloo_threads() -> int:
    """This process's native gloo threads (``pt_gloo_runloop``,
    ``gloo_tcp_loop``), from the thread names the kernel keeps."""
    n = 0
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                n += "gloo" in f.read()
        except OSError:
            pass
    return n


def teardown_threads_run(rank, world, device, out_dir):
    """A rank that leaves its groups where a trainer leaves them: a mesh
    and the hierarchical layout (cached per default group) and the
    default group in a reference cycle. At the interpreter's exit it
    writes the number of native gloo threads still running to
    ``out_dir/<rank>``."""
    import atexit

    from distributed_mnist_bnns_tpu_torch.parallel import make_mesh

    def report():
        with open(os.path.join(out_dir, str(rank)), "w") as f:
            f.write(str(_native_gloo_threads()))

    atexit.register(report)
    make_mesh(data=1, model=world)
    groups = make_groups(hosts=world, local=1)
    x = torch.ones(2)
    dist.all_reduce(x, group=groups.inter)
    cycle = {"group": dist.group.WORLD}
    cycle["self"] = cycle
    return float(x.sum())


def dies_run(rank, world, device, how):
    """After a barrier (every rank through its rendezvous: a rank that
    returned at once could close its side of the mesh while a slower
    peer still connects), rank 1 writes a line to its stderr, then exits
    with code 3 (``how="exit"``) or aborts (``how="abort"``); the others
    return."""
    import signal
    import sys

    dist.barrier()
    if rank == 1:
        print(f"rank 1 about to {how}", file=sys.stderr, flush=True)
        if how == "exit":
            os._exit(3)
        os.kill(os.getpid(), signal.SIGABRT)
    return rank
