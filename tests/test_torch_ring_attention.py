"""Sequence-parallel ring attention in the PyTorch port, against the JAX
package's ``parallel/ring_attention.py``.

2 and 4 gloo ranks (``parallel.spawn``, one spawn per world runs every
case; the rank side is ``tests/torch_ring_util.py``) and the (2 data x 4
seq) grid of 8 ranks run ``make_ring_attention`` on their shards of one
numpy (q, k, v); the JAX package runs its ring on as many of the forced
CPU devices (flash in interpret mode). Held, for the dense and the flash
local step, causal and not:

  * each rank's output shard to JAX's within 2e-5 (JAX's own tests'
    tolerance; the grid's 2e-4 as JAX's);
  * the gradients of the summed squared output with respect to each
    rank's q, k, v shards to ``jax.grad`` of JAX's ring within 1e-4
    (``test_ring_flash_causal_differentiable``'s): the shift's backward
    carries each shard's cotangent back to its owner;
  * the LM: ``lm_demo.ring_loss`` over the tiny LM with the ring as its
    ``attention_fn``, gradients summed over the ranks, against
    ``jax.grad`` of the JAX BinarizedLM whose ``attention_fn`` is JAX's
    ring: the loss within 1e-6, each parameter's gradient within 1e-4 of
    its norm (measured: at most 5e-6), the key bias's, exactly 0 in exact
    arithmetic and rounding noise on both sides (2.5e-5 here, 5e-7 in
    JAX), within 1e-4 of its block's query-bias gradient.

Then ``lm_demo.run(ring=True)`` (2 gloo ranks) and ``cli lm --ring`` on the CPU against the
plain run, and ``make_ring_attention``'s refusal of an unknown local step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from distributed_mnist_bnns_tpu.models.transformer import lm_loss as j_loss
from distributed_mnist_bnns_tpu.parallel.ring_attention import (
    make_ring_attention as jax_ring,
)
from distributed_mnist_bnns_tpu_torch import cli
from distributed_mnist_bnns_tpu_torch.examples import lm_demo
from distributed_mnist_bnns_tpu_torch.interop import lm_params_from_jax
from distributed_mnist_bnns_tpu_torch.parallel import (
    make_ring_attention,
    spawn,
)
from tests.torch_lm_util import TINY, jax_lm, numpy_params
from tests.torch_ring_util import CASES, ring_rank

OUT_ATOL, GRAD_ATOL, GRID_ATOL = 2e-5, 1e-4, 2e-4
LM_GRAD_RTOL = 1e-4
B, H, D = 4, 2, 8


def _qkv(length):
    rng = np.random.RandomState(length)
    return tuple(rng.randn(B, length, H, D).astype(np.float32)
                 for _ in range(3))


def _lm_inputs(seed=5):
    jm = jax_lm()
    params = numpy_params(jm, seed)
    toks = np.random.RandomState(seed).randint(
        0, TINY["vocab"], (2, TINY["max_len"])).astype(np.int64)
    return params, toks


@pytest.fixture(scope="module")
def runs():
    """world -> (seq ranks, inputs, each rank's results, LM inputs), one
    spawn per world, made on first use."""
    cache = {}

    def get(world):
        if world not in cache:
            if world == "grid":
                qkv = _qkv(16)
                ranks = spawn(ring_rank, 8, backend="gloo", device="cpu",
                              args=(qkv, (2, 4)))
                cache[world] = (4, qkv, ranks, None)
            else:
                qkv, lm = _qkv(8 * world), _lm_inputs()
                ranks = spawn(ring_rank, world, backend="gloo",
                              device="cpu",
                              args=(qkv, None, (*lm, TINY["num_heads"])))
                cache[world] = (world, qkv, ranks, lm)
        return cache[world]

    return get


def _jax_mesh(world):
    devices = np.array(jax.devices()[:8 if world == "grid" else world])
    if world == "grid":
        return Mesh(devices.reshape(2, 4), ("data", "seq"))
    return Mesh(devices, ("seq",))


@pytest.mark.parametrize("local,causal", CASES)
@pytest.mark.parametrize("world", [2, 4, "grid"])
def test_ring_matches_jax_ring(runs, world, local, causal):
    n_seq, qkv, ranks, _ = runs(world)
    ring = jax_ring(_jax_mesh(world), causal=causal, local=local,
                    interpret=local == "flash")
    q, k, v = (jnp.asarray(a) for a in qkv)
    out = np.asarray(ring(q, k, v))
    grads = jax.grad(lambda q, k, v: (ring(q, k, v) ** 2).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    n_data = 2 if world == "grid" else 1
    bb, ll = B // n_data, qkv[0].shape[1] // n_seq
    atol = GRID_ATOL if world == "grid" else OUT_ATOL
    for res in ranks:
        d, s = res["coords"]
        rows, cols = slice(d * bb, (d + 1) * bb), slice(s * ll, (s + 1) * ll)
        got = res[(local, causal)]
        np.testing.assert_allclose(got["out"], out[rows, cols], atol=atol,
                                   rtol=atol)
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(
                got[name], np.asarray(g)[rows, cols],
                atol=max(atol, GRAD_ATOL), rtol=max(atol, GRAD_ATOL),
                err_msg=f"{name} of rank ({d}, {s})")


@pytest.mark.parametrize("world", [2, 4])
def test_lm_ring_gradients_match_jax(runs, world):
    _, _, ranks, (params, toks) = runs(world)
    jm = jax_lm(attention_fn=jax_ring(_jax_mesh(world), causal=True))
    # jitted, as the JAX lm_demo's ring step
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: j_loss(jm.apply({"params": p}, jnp.asarray(toks)),
                         jnp.asarray(toks))))(params)
    want = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, g),
                              num_heads=TINY["num_heads"]).state_dict()
    for res in ranks:
        got = res["lm"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
        for name, grad in got["grads"].items():
            ref = want[name].numpy()
            err = np.linalg.norm(grad - ref)
            if name.endswith("attn.k.bias"):
                # exactly 0 in exact arithmetic: both sides give rounding
                # noise, held to the scale of the block's query bias's
                scale = np.linalg.norm(want[name[:-6] + "q.bias"].numpy())
                assert err <= LM_GRAD_RTOL * scale, (name, err, scale)
            else:
                assert err <= LM_GRAD_RTOL * np.linalg.norm(ref), (
                    name, err, np.linalg.norm(ref))


def test_lm_demo_ring_run_equals_the_plain_run(capsys):
    """``run(ring=True)`` over 2 gloo ranks trains what ``run()`` trains:
    its loss history within 1e-5 relative, its greedy sample equal;
    ``cli lm --ring`` reports the ring run's history."""
    kw = dict(steps=3, seq_len=16, batch=2, vocab=32, embed_dim=32,
              depth=2, num_heads=2, device="cpu", log_every=1, sample=4,
              temperature=0.0)
    plain = lm_demo.run(**kw)
    ring = lm_demo.run(ring=True, **kw)
    np.testing.assert_allclose(ring.history, plain.history, rtol=1e-5)
    assert ring.sample == plain.sample and len(ring.ranks) == 2
    assert all(r["history"] == ring.history for r in ring.ranks)
    capsys.readouterr()
    assert cli.main(["lm", "--steps", "3", "--ring", "--seq-len", "16",
                     "--batch-size", "2", "--vocab", "32", "--embed-dim",
                     "32", "--depth", "2", "--num-heads", "2", "--attention",
                     "xla", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the CLI logs every 25 steps and the last: steps 0 and 2
    np.testing.assert_allclose(got["loss_history"],
                               [ring.history[0], ring.history[-1]],
                               rtol=1e-6)
    with pytest.raises(SystemExit, match="--ring is a training topology"):
        cli.main(["lm", "--ring", "--load", "x.msgpack", "--device", "cpu"])


def test_unknown_local_step_is_refused():
    with pytest.raises(ValueError, match="unknown local='splash'"):
        make_ring_attention(local="splash")
