"""Rank side of the ring-attention tests of the PyTorch port (imports no
JAX): each spawned gloo rank runs the port's ring over its shards of the
same numpy inputs and returns its output and gradient shards."""

import numpy as np
import torch
import torch.distributed as dist

CASES = [(local, causal) for local in ("dense", "flash")
         for causal in (False, True)]


def _shard(a, d, n_data, s, n_seq):
    b, length = a.shape[:2]
    bb, ll = b // n_data, length // n_seq
    return a[d * bb:(d + 1) * bb, s * ll:(s + 1) * ll]


def ring_rank(rank, world, device, qkv, grid=None, lm=None):
    """Every (local, causal) case of ``make_ring_attention`` on this
    rank's shards of ``qkv`` ((B, L, H, D) numpy q, k, v): the output
    shard and the gradients of the whole sum of squared outputs with
    respect to this rank's q, k and v shards. ``grid`` (data, seq) runs
    a ring over each data row of a ``parallel.Mesh``. ``lm`` (flax params
    of the tiny LM, tokens, heads): ``lm_demo.ring_loss`` over the ring,
    the summed gradients in the port's names."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        Mesh,
        make_ring_attention,
    )

    torch.set_num_threads(1)
    if grid is None:
        mesh, (n_data, n_seq), (d, s) = None, (1, world), (0, rank)
    else:
        mesh = Mesh(grid, ("data", "seq"))
        n_data, n_seq = grid
        d, s = mesh.index("data"), mesh.index("seq")
    out = {"coords": (d, s)}
    for local, causal in CASES:
        ring = make_ring_attention(mesh, causal=causal, local=local)
        q, k, v = (torch.from_numpy(_shard(a, d, n_data, s, n_seq).copy())
                   .requires_grad_(True) for a in qkv)
        o = ring(q, k, v)
        (o ** 2).sum().backward()
        out[(local, causal)] = {
            "out": o.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    if lm is not None:
        out["lm"] = _lm_grads(*lm)
    return out


def _lm_grads(params, tokens, num_heads):
    from distributed_mnist_bnns_tpu_torch.examples.lm_demo import ring_loss
    from distributed_mnist_bnns_tpu_torch.interop import lm_params_from_jax
    from distributed_mnist_bnns_tpu_torch.parallel import (
        make_ring_attention,
    )

    model = lm_params_from_jax(
        params, num_heads=num_heads, backend="xla",
        attention_fn=make_ring_attention(causal=True))
    loss = ring_loss(model, torch.from_numpy(tokens))
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        dist.all_reduce(p.grad)
        grads[name] = p.grad.numpy()
    total = loss.detach().clone()
    dist.all_reduce(total)
    return {"loss": float(total), "grads": grads}
