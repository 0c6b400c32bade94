"""The rank side of the port's expert-parallel and sharded-predictor
tests (imports no JAX): ``tests/test_torch_expert_parallel.py`` and
``test_torch_infer_sharded.py`` start gloo ranks on the CPU with
``parallel.spawn`` and run these, on numpy inputs, returning numpy
results that the tests hold against the JAX package in the parent."""

import numpy as np
import torch
import torch.distributed as dist


def ep_run(rank, world, device, cases):
    """Each case ``(params, gate_w, x, capacity, k, ranks)`` through
    ``make_expert_parallel_moe`` over the group of ``ranks`` (every
    rank builds every group; ranks outside one skip its case): this
    rank's output rows, and the gradients of the whole sum of squared
    outputs (summed over the group) with respect to the expert params,
    the gate and the tokens."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        make_expert_parallel_moe,
    )

    torch.set_num_threads(1)
    out = []
    groups = [dist.new_group(list(c[5])) for c in cases]
    for (params, gate_w, x, capacity, k, ranks), group in zip(cases, groups):
        if rank not in ranks:
            out.append(None)
            continue
        p = {key: torch.from_numpy(v.copy()).requires_grad_(True)
             for key, v in params.items()}
        g = torch.from_numpy(gate_w.copy()).requires_grad_(True)
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        moe = make_expert_parallel_moe(group, capacity=capacity, k=k)
        y = moe(p, g, xt)
        (y ** 2).sum().backward()
        grads = {}
        for name, t in (("w", p["w"]), ("b", p["b"]), ("gate_w", g),
                        ("x", xt)):
            s = t.grad.clone()
            dist.all_reduce(s, group=group)
            grads[name] = s.numpy()
        try:
            moe(p, g, xt[:-1])
            raises = False
        except ValueError:
            raises = True
        out.append({"out": y.detach().numpy(), "grads": grads,
                    "raises_on_indivisible": raises})
    return out


def sharded_run(rank, world, device, cases):
    """Each ``(frozen numpy dict, images)`` through
    ``infer.make_sharded_predictor`` over the world: the gathered
    log-probs, and whether a batch the world does not divide raises."""
    from distributed_mnist_bnns_tpu_torch.infer import make_sharded_predictor
    from distributed_mnist_bnns_tpu_torch.interop import frozen_from_jax

    torch.set_num_threads(1)
    out = []
    for frozen, x in cases:
        fn = make_sharded_predictor(frozen_from_jax(frozen), device="cpu")
        y = fn(torch.from_numpy(x)).numpy()
        try:
            fn(torch.from_numpy(x[:-1]))
            raises = False
        except ValueError:
            raises = True
        out.append({"out": y, "raises_on_indivisible": raises})
    return out
