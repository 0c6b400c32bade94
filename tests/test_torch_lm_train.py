"""The port's LM training step (``examples/lm_demo.py``) against the JAX
package's ``lm_demo`` step, and the latent clamp.

The tiny LM of ``tests/torch_lm_util.py`` with numpy parameters (non-zero
biases) is carried into the port with ``interop.lm_params_from_jax``.
Both sides take three steps on the same numpy batch: forward, ``lm_loss``,
backward, Adam 1e-3 (optax's and PyTorch's, the same update rounded in
another order), latent clamp. The losses agree per step to rtol 1e-5 and
every parameter after step 3 to atol 2e-5 (three Adam steps move a
parameter by at most 3e-3; the two sides' gradients differ by fp32
rounding of sums taken in other orders).

One parameter is held apart: the key projection's bias. Adding a vector
b to every key adds q_i . b to every score of row i, which the softmax
ignores, so its exact gradient is 0 and both sides compute rounding
noise; Adam divides that noise by its own magnitude and moves the bias
by up to the learning rate in the noise's direction. Its moves are held
to the step bound only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_mnist_bnns_tpu.models import latent_clamp_mask as j_mask
from distributed_mnist_bnns_tpu.models.transformer import lm_loss as j_loss
from distributed_mnist_bnns_tpu.train import clamp_latent as j_clamp
from distributed_mnist_bnns_tpu_torch.examples import lm_demo
from distributed_mnist_bnns_tpu_torch.interop import lm_params_from_jax
from distributed_mnist_bnns_tpu_torch.models import (
    BinarizedLM,
    latent_clamp_mask,
    lm_loss,
)
from distributed_mnist_bnns_tpu_torch.train import clamp_latent
from tests.torch_lm_util import TINY, jax_lm, numpy_params

LR = 1e-3
STEPS = 3


def _jax_steps(jm, params, toks):
    """The JAX lm_demo step: value_and_grad of lm_loss, optax adam,
    apply_updates, clamp_latent with latent_clamp_mask."""
    mask = j_mask(params)
    tx = optax.adam(LR)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt):
        def loss_fn(p):
            return j_loss(jm.apply({"params": p}, toks, train=False), toks)

        loss, g = jax.value_and_grad(loss_fn)(params)
        up, opt = tx.update(g, opt, params)
        return j_clamp(optax.apply_updates(params, up), mask), opt, loss

    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("backend", ["xla", "bf16"])
@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_three_steps_match_the_jax_lm_demo_step(attention, backend):
    jm = jax_lm(backend=backend, attention=(
        "flash_interpret" if attention == "flash" else "xla"))
    params = numpy_params(jm, seed=0)
    toks = np.random.RandomState(7).randint(
        0, TINY["vocab"], (2, 24)).astype(np.int32)
    want_params, want_losses = _jax_steps(jm, params, jnp.asarray(toks))

    model = lm_params_from_jax(params, num_heads=TINY["num_heads"],
                               attention=attention, backend=backend)
    opt = lm_demo.make_optimizer(model, LR)
    latents = list(latent_clamp_mask(model).values())
    tt = torch.from_numpy(toks).long()
    losses = [float(lm_demo.train_step(model, opt, latents, tt))
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0)

    want = lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, want_params),
        num_heads=TINY["num_heads"]).state_dict()
    got = model.state_dict()
    start = lm_params_from_jax(params, num_heads=TINY["num_heads"]).state_dict()
    assert set(got) == set(want)
    for name in want:
        if name.endswith("attn.k.bias"):
            for side in (got, want):
                moved = (side[name] - start[name]).abs().max().item()
                assert moved <= STEPS * LR * 1.01, (name, moved)
            continue
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=0, err_msg=name)


def test_lm_loss_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 9, 11).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits)))
    toks = rng.randint(0, 11, (2, 9)).astype(np.int32)
    want = float(j_loss(jnp.asarray(lp), jnp.asarray(toks)))
    got = float(lm_loss(torch.from_numpy(lp), torch.from_numpy(toks)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("binarized_attention", [True, False])
def test_clamp_mask_is_the_jax_mask(binarized_attention):
    """The same parameters are selected as the JAX rule selects from the
    flax tree: BinarizedDense weights and biases, not the fp32 attention
    of binarized_attention=False, LN, embeddings or the head."""
    jm = jax_lm(binarized_attention=None if binarized_attention else False)
    params = numpy_params(jm, seed=1)
    n_jax = sum(bool(leaf) for leaf in jax.tree_util.tree_leaves(
        j_mask(params)))
    model = lm_params_from_jax(params, num_heads=TINY["num_heads"])
    mask = latent_clamp_mask(model)
    assert len(mask) == n_jax
    per_block = 12 if binarized_attention else 4
    assert len(mask) == per_block * TINY["depth"]
    assert "blocks.0.mlp1.weight" in mask and "blocks.1.mlp2.bias" in mask
    assert ("blocks.0.attn.q.weight" in mask) == binarized_attention
    assert not any(n.startswith(("tok_embed", "pos_embed", "head", "ln_"))
                   or ".ln_" in n for n in mask)


def test_clamp_latent_clamps_only_the_latents_in_place():
    model = BinarizedLM(**TINY, backend="xla")
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0).add_(3.0)
    mask = latent_clamp_mask(model)
    before = {n: p.data_ptr() for n, p in model.named_parameters()}
    clamp_latent(mask.values())
    for name, p in model.named_parameters():
        assert p.data_ptr() == before[name]
        want = 1.0 if name in mask else 3.0
        assert torch.equal(p, torch.full_like(p, want)), name


def test_token_stream_is_the_jax_demos():
    """The periodic corpus and the corpus windows are drawn from
    RandomState(seed) exactly as the JAX lm_demo draws them."""
    vocab, draw = lm_demo.token_stream(12, 3, 40, seed=5)
    rng = np.random.RandomState(5)
    base = rng.randint(0, 40, (3, 3))
    assert vocab == 40
    np.testing.assert_array_equal(draw(), np.tile(base, (1, 4)))
    np.testing.assert_array_equal(draw(), np.tile(base, (1, 4)))


def test_token_stream_reads_corpus_windows(tmp_path):
    data = bytes(range(256)) * 2
    path = tmp_path / "corpus.bin"
    path.write_bytes(data)
    vocab, draw = lm_demo.token_stream(16, 4, 64, seed=2, corpus=str(path))
    rng = np.random.RandomState(2)
    starts = rng.randint(0, len(data) - 16, size=4)
    assert vocab == 256
    want = np.stack([np.frombuffer(data, np.uint8)[s:s + 16] for s in starts])
    np.testing.assert_array_equal(draw(), want)
    with pytest.raises(ValueError, match="need more"):
        lm_demo.token_stream(600, 1, 64, seed=0, corpus=str(path))


def test_run_trains_and_exports_on_cpu(tmp_path):
    out = tmp_path / "lm.msgpack"
    res = lm_demo.run(steps=6, seq_len=16, batch=4, vocab=16, embed_dim=16,
                      depth=1, num_heads=2, lr=3e-3, log_every=2,
                      attention="flash", export=str(out), device="cpu")
    assert len(res.history) == 4 and all(np.isfinite(res.history))
    assert res.export["kind"] == "lm" and out.is_file()
    for p in latent_clamp_mask(res.model).values():
        assert float(p.detach().abs().max()) <= 1.0


def test_run_refuses_what_is_not_ported():
    # the ring and the pipeline (pp > 1) are ported; what JAX refuses
    # with them, the port refuses with JAX's messages
    with pytest.raises(ValueError, match="--export requires the plain"):
        lm_demo.run(steps=1, ring=True, export="lm.msgpack", device="cpu")
    with pytest.raises(ValueError, match="divisible by 2 ranks"):
        lm_demo.run(steps=1, ring=True, seq_len=15, device="cpu")
    with pytest.raises(ValueError, match="--export requires the plain"):
        lm_demo.run(steps=1, pp=2, export="lm.msgpack", device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        lm_demo.run(steps=1, pp=2, ring=True, device="cpu")
    with pytest.raises(ValueError, match="steps"):
        lm_demo.run(steps=0, device="cpu")
