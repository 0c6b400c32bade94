"""The rank side of the port's model-parallel parity tests.

``tests/test_torch_model_parallel.py``, ``test_torch_pipeline.py`` and
``test_torch_pipeline_model.py`` start gloo ranks on the CPU with
``parallel.spawn`` and run the functions here in each (``jobs_rank``: a
list of named jobs, one spawn per world). The functions import only
torch and the port (never JAX), take numpy inputs and return numpy
results, which the tests hold against the JAX package in the parent.
"""

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from distributed_mnist_bnns_tpu_torch.models.layers import hard_tanh
from distributed_mnist_bnns_tpu_torch.ops.binarize import binarize_ste


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy().copy()
    return np.asarray(tree)


def _trainer(cfg_kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    cfg = dict(model="bnn-mlp-small", backend="xla", seed=0, device="cpu",
               log_interval=1)
    cfg.update(cfg_kw)
    return Trainer(TrainConfig(**cfg))


def load_variables(t, variables):
    """A JAX model's full ``{"params", "batch_stats"}`` (numpy) into a
    trainer of any layout: its own state tree with those leaves put in,
    loaded back (a tensor-parallel trainer cuts its shards)."""
    from distributed_mnist_bnns_tpu_torch.interop import (
        train_state_from_jax,
        train_state_to_jax,
    )

    state = _np(train_state_to_jax(t))
    state["params"] = variables["params"]
    if variables.get("batch_stats"):
        state["batch_stats"] = variables["batch_stats"]
    train_state_from_jax(state, t)


def _full_state(t):
    from distributed_mnist_bnns_tpu_torch.interop import train_state_to_jax

    return _np(train_state_to_jax(t))


def _replicated_digest(t) -> str:
    """A digest of the model's replicated leaves (not sharded over the
    model group)."""
    h = hashlib.sha256()
    tensors = {**dict(t.model.named_parameters()),
               **dict(t.model.named_buffers())}
    for name, v in sorted(tensors.items()):
        if name.endswith("num_batches_tracked"):
            continue
        if t.tp is None or t.tp.dims.get(v) is None:
            h.update(name.encode() + _np(v).tobytes())
    return h.hexdigest()


def _steps(t, xs, ys):
    losses = []
    for x, y in zip(xs, ys):
        xb = torch.from_numpy(np.ascontiguousarray(t._shard(x)))
        yb = torch.from_numpy(np.ascontiguousarray(t._shard(y)).astype(
            np.int64))
        loss, _ = t.train_step(t.model, t.optimizer, xb, yb)
        losses.append(float(loss))
    t.step += len(xs)
    return losses


def steps_run(rank, world, device, cfg_kw, variables, xs, ys):
    """Steps of the trainer of ``cfg_kw`` from ``variables``: losses, the
    gathered state (rank 0), the replicated leaves' digest, the local
    parameter shapes and the wire bytes."""
    t = _trainer(cfg_kw)
    if variables is not None:
        load_variables(t, variables)
    losses = _steps(t, xs, ys)
    state = _full_state(t)
    return {"losses": losses, "state": state if rank == 0 else None,
            "repl": _replicated_digest(t),
            "shapes": {k: tuple(v.shape)
                       for k, v in t.model.named_parameters()},
            "wire": {f"{lv}/{ph}": n for (lv, ph), n in t.wire.items()},
            "optimizer": type(t.optimizer).__name__,
            "norm_shards": t.optimizer.tp is not None}


def _mlp_features(model, x):
    x = x.reshape(x.shape[0], -1)
    x = hard_tanh(model.bn1(model.fc1(x)))
    x = hard_tanh(model.bn2(model.fc2(x)))
    return hard_tanh(model.bn3(model.dropout(model.fc3(x))))


def tp_forward_run(rank, world, device, cfg_kw, variables, x):
    """The TP model's eval forward up to the head (gathered over the model
    group) and its logits against the unsharded model of the same
    weights, on this rank."""
    from distributed_mnist_bnns_tpu_torch.interop import params_from_jax
    from distributed_mnist_bnns_tpu_torch.models import get_model

    t = _trainer(cfg_kw)
    load_variables(t, variables)
    full = params_from_jax(variables, get_model(
        cfg_kw.get("model", "bnn-mlp-small"), backend=cfg_kw["backend"],
        **cfg_kw.get("model_kwargs", {})))
    t.model.eval()
    xb = torch.from_numpy(x)
    with torch.no_grad():
        part = _mlp_features(t.model, xb)
        shards = [torch.empty_like(part) for _ in range(t.tp.tp)]
        dist.all_gather(shards, part.contiguous(), group=t.tp.group)
        got = torch.cat(shards, dim=1)
        want = _mlp_features(full, xb)
        logits = (t.model(xb) - full(xb)).abs().max()
    return {"equal": bool(torch.equal(got, want)),
            "err": float((got - want).abs().max()),
            "logits_err": float(logits)}


def fit_run(rank, world, device, cfg_kw, sizes):
    """``Trainer.fit`` on the synthetic split: history, local shapes, the
    optimizer's class and whether it holds the TP norms."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    t = _trainer(cfg_kw)
    data = load_mnist("/nonexistent-mnist-dir", synthetic_sizes=sizes, seed=0)
    history = t.fit(data)
    state = _full_state(t)   # collective: every rank gathers
    return {"history": history,
            "shapes": {k: tuple(v.shape)
                       for k, v in t.model.named_parameters()},
            "optimizer": type(t.optimizer).__name__,
            "norm_shards": getattr(t.optimizer, "tp", None) is not None,
            "state": state if rank == 0 else None}


def resume_run(rank, world, device, cfg_kw, ckpt_dir, xs, ys, split):
    """``len(xs)`` steps uninterrupted, against ``split`` steps, a
    checkpoint, a fresh trainer restored from it and the rest: both
    final states and the saved one (gathered) and the checkpoint's
    files."""
    a = _trainer(cfg_kw)
    _steps(a, xs, ys)
    b = _trainer(cfg_kw)
    _steps(b, xs[:split], ys[:split])
    saved = _full_state(b)
    b.save_checkpoint(ckpt_dir)
    c = _trainer(cfg_kw)
    c.restore(ckpt_dir)
    _steps(c, xs[split:], ys[split:])
    sa, sc = _full_state(a), _full_state(c)
    return {"uninterrupted": sa if rank == 0 else None,
            "resumed": sc if rank == 0 else None,
            "saved": saved if rank == 0 else None,
            "files": sorted(os.listdir(ckpt_dir))}


def raises_run(rank, world, device, cases):
    """Each config of ``cases`` built into a Trainer in this rank: the
    exception's type name and message (or None)."""
    out = []
    for cfg_kw in cases:
        try:
            _trainer(cfg_kw)
            out.append(None)
        except (ValueError, NotImplementedError) as e:
            out.append((type(e).__name__, str(e)))
    return out


# -- pipelines -------------------------------------------------------------


def residual_stage(params, x):
    """A binarized residual stage: x + hardtanh(sign(x) @ sign(W))."""
    return x + torch.clamp(
        binarize_ste(x) @ binarize_ste(params["w"]), -1.0, 1.0)


def dropout_stage(params, x, gen):
    """A stage that draws: x @ W masked by a Bernoulli(0.7) draw."""
    keep = torch.rand(x.shape, generator=gen) < 0.7
    return torch.where(keep, x @ params["w"], torch.zeros_like(x))


def pipeline_run(rank, world, device, cases):
    """Each case ``(n_micro, params, x, kind, remat)`` through
    ``make_pipeline_fn`` over all ranks: the output, and for "grad" the
    gradient of sum(y^2) w.r.t. the stacked params, for "rng" the output
    with ``seed`` 7 and its sequential oracle's."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        Mesh,
        make_pipeline_fn,
        sequential_reference_rng,
    )

    mesh = Mesh((world,), ("pipe",))
    out = []
    for n_micro, params, x, kind, remat in cases:
        p = {k: torch.tensor(v, requires_grad=True) for k, v in
             params.items()}
        xt = torch.from_numpy(x)
        if kind == "rng":
            f = make_pipeline_fn(mesh, dropout_stage, n_micro=n_micro,
                                 stage_takes_rng=True, stage_remat=remat)
            y = f(p, xt, 7)
            (y ** 2).sum().backward()
            with torch.no_grad():
                want = sequential_reference_rng(
                    {k: v.detach() for k, v in p.items()}, xt,
                    dropout_stage, 7, n_micro)
            out.append({"y": _np(y), "oracle": _np(want),
                        "grad": _np(p["w"].grad)})
            continue
        f = make_pipeline_fn(mesh, residual_stage, n_micro=n_micro,
                             stage_remat=remat)
        y = f(p, xt)
        (y ** 2).sum().backward()
        grad = p["w"].grad
        dist.all_reduce(grad)   # each stage holds its own slice's
        out.append({"y": _np(y), "grad": _np(grad)})
    return out


def dp_pipeline_run(rank, world, device, params, x, n_micro):
    """DP x PP: a (data 2, pipe world/2) mesh, each row its rows of ``x``
    through ``residual_stage``; this row's output."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        Mesh,
        make_pipeline_fn,
    )

    mesh = Mesh((2, world // 2), ("data", "pipe"))
    f = make_pipeline_fn(mesh, residual_stage, n_micro=n_micro,
                         batch_axis="data")
    rows = x.shape[0] // 2
    d = mesh.index("data")
    y = f({k: torch.from_numpy(v) for k, v in params.items()},
          torch.from_numpy(x[d * rows:(d + 1) * rows]))
    return {"row": d, "y": _np(y)}


def tp_pipeline_run(rank, world, device, params, x, target, steps, lr):
    """``make_tp_pipeline_fn`` at (data 1, model 2, pipe world/2): the
    forward, then ``steps`` SGD steps on sum((y - target)^2) / B with
    the latents clamped; this rank's slices of the parameters after
    them (the others never move here)."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        latent_mask,
        make_mesh,
        make_tp_pipeline_fn,
    )

    mesh = make_mesh(data=1, model=2, pipe=world // 2)
    f = make_tp_pipeline_fn(mesh)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    with torch.no_grad():
        y0 = _np(f(p, xt))
    mask = latent_mask(params)
    losses = []
    for _ in range(steps):
        loss = ((f(p, xt) - tt) ** 2).sum() / x.shape[0]
        loss.backward()
        with torch.no_grad():
            for k, v in p.items():
                v -= lr * v.grad
                v.grad = None
                if mask[k]:
                    v.clamp_(-1.0, 1.0)
        losses.append(float(loss.detach()))
    return {"y0": y0, "losses": losses, "params": _np(p),
            "coords": (mesh.index("model"), mesh.index("pipe"))}


def mesh_run(rank, world, device):
    """Each mesh's shape, this rank's coordinates and the ranks of its
    group along each axis (a sum over the group of each member's rank)."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        make_hybrid_mesh,
        make_mesh,
    )

    out = []
    for mesh in (make_mesh(model=2), make_mesh(data=1, model=2, pipe=2),
                 make_hybrid_mesh({"model": 2})):
        lines = {}
        for axis in mesh.axis_names:
            t = torch.tensor([float(rank)])
            dist.all_reduce(t, group=mesh.group(axis))
            lines[axis] = (list(mesh.line(axis)), float(t))
        out.append((mesh.shape, dict(mesh.coords), lines))
    try:
        make_mesh(model=3)
        bad = None
    except ValueError as e:
        bad = str(e)
    return {"meshes": out, "bad": bad}


# -- pipelined models --------------------------------------------------------


def _model_from(kind, params, **kw):
    from distributed_mnist_bnns_tpu_torch.interop import (
        lm_params_from_jax,
        params_from_jax,
    )

    if kind == "lm":
        return lm_params_from_jax(params, backend="xla", **kw)
    return params_from_jax({"params": params}, backend="xla", **kw)


def pipelined_forward_run(rank, world, device, cases):
    """Each case ``(kind, params, x, n_micro, model kwargs)``: the
    pipelined model's eval forward over all ranks (``make_pipelined_apply``)
    and its flax params tree (gathered)."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        Mesh,
        make_pipelined_apply,
    )

    out = []
    for kind, params, x, n_micro, kw in cases:
        model = _model_from(kind, params, **kw)
        apply = make_pipelined_apply(model, Mesh((world,), ("pipe",)),
                                     model.depth, n_micro=n_micro)
        with torch.no_grad():
            y = apply(torch.from_numpy(x))
        out.append({"y": _np(y), "tree": _np(apply.module.flax_params())})
    return out


def pipelined_dropout_run(rank, world, device, params, x, n_micro, seed):
    """A ViT with dropout 0.3, pipelined, its train forward with the step
    seed ``seed``, against the rng-matched oracle built here from the full
    model: each microbatch through each stage's blocks with that cell's
    generator. Also the missing-seed error."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        Mesh,
        cell_generator,
        make_pipelined_apply,
    )

    full = _model_from("vit", params, num_heads=2, dropout=0.3)
    model = _model_from("vit", params, num_heads=2, dropout=0.3)
    apply = make_pipelined_apply(model, Mesh((world,), ("pipe",)),
                                 model.depth, n_micro=n_micro)
    xt = torch.from_numpy(x)
    try:
        apply(xt, train=True)
        missing = None
    except ValueError as e:
        missing = str(e)
    with torch.no_grad():
        y = apply(xt, train=True, seed=seed)
        full.train()
        h = full.embed_tokens(xt)
        per = full.depth // world
        outs = []
        for m, hm in enumerate(h.chunk(n_micro)):
            for s in range(world):
                gen = cell_generator(seed, m, s, hm.device)
                for blk in list(full.blocks)[s * per:(s + 1) * per]:
                    hm = blk(hm, gen)
            outs.append(hm)
        want = full.head_out(torch.cat(outs))
    return {"y": _np(y), "want": _np(want), "missing": missing}


def lm_pp_run(rank, world, device, kw):
    """``lm_demo.run(pp=world)`` cannot nest spawns: its rank function
    run in this rank, the result of rank 0."""
    from distributed_mnist_bnns_tpu_torch.examples import lm_demo

    res = lm_demo._pp_rank(rank, world, device, kw)
    return res if rank == 0 else None


def jobs_rank(rank, world, device, jobs):
    """Each named job ``(name, function name, arguments)`` of this module
    in turn; {name: result}."""
    torch.set_num_threads(1)
    return {name: globals()[fn](rank, world, device, *args)
            for name, fn, args in jobs}


def pipeline_gauges_run(rank, world, device, cases):
    """Each ``(n_stages, n_micro)``: a pipeline over a (data, pipe) mesh
    of ``world // n_stages`` x ``n_stages``, called once; the
    ``pipeline_*`` gauges and the call counter of the default registry
    after it."""
    from distributed_mnist_bnns_tpu_torch.obs import default_registry
    from distributed_mnist_bnns_tpu_torch.parallel import (
        Mesh,
        make_pipeline_fn,
    )

    out = []
    for n_stages, n_micro in cases:
        rows = world // n_stages
        mesh = Mesh((rows, n_stages), ("data", "pipe"))
        f = make_pipeline_fn(mesh, residual_stage, n_micro=n_micro,
                             batch_axis="data" if rows > 1 else None)
        w = torch.from_numpy(np.random.RandomState(0).randn(
            n_stages, 4, 4).astype(np.float32))
        f({"w": w}, torch.ones(n_micro * 2, 4))
        snap = default_registry().snapshot()
        out.append({name: snap[name]["series"] for name in (
            "pipeline_stages", "pipeline_microbatches",
            "pipeline_bubble_fraction", "pipeline_calls_total")})
    return out


def dispatch_fit_run(rank, world, device, cfg_kw, variables, n, epochs=1):
    """``Trainer.fit`` on ``n`` numpy-seeded examples (the JAX
    tests/test_compositions.py ``_data(n)``) from ``variables`` (None:
    the trainer's own init): the history, the gathered state (rank 0),
    the launches the step ran in graphs or chunks and whether the model
    stayed sharded."""
    from distributed_mnist_bnns_tpu_torch.data.common import ImageClassData

    rng = np.random.RandomState(0)
    data = ImageClassData(
        train_images=rng.rand(n, 28, 28, 1).astype(np.float32),
        train_labels=rng.randint(0, 10, n).astype(np.int32),
        test_images=rng.rand(16, 28, 28, 1).astype(np.float32),
        test_labels=rng.randint(0, 10, 16).astype(np.int32))
    t = _trainer(dict(cfg_kw, epochs=epochs))
    if variables is not None:
        load_variables(t, variables)
    history = t.fit(data)
    state = _full_state(t)
    return {"history": history, "state": state if rank == 0 else None,
            "step": t.step, "mp": t.mp,
            "shapes": {k: tuple(v.shape)
                       for k, v in t.model.named_parameters()},
            "optimizer": type(t.optimizer).__name__,
            "refuse": (t._train_scan.refuse if t._train_scan is not None
                       else None)}
