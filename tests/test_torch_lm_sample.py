"""Sampling in the PyTorch port: ``cli lm --load --sample --temperature``,
``infer_transformer.generate``'s sampler and ``lm_demo.run(sample=...)``.

JAX's PRNG bits cannot be reproduced in PyTorch, so sampled tokens are
not compared with the JAX package's. What is held instead:

  * greedy output (``--temperature 0``) token for token to the JAX
    package's ``generate`` on the same weights (the tiny LM of
    ``tests/torch_lm_util.py``; JAX's Pallas kernels in interpret mode);
  * a seeded run at T > 0 repeats from its seed;
  * the sampled distribution: 20,000 draws from one fixed log-prob row
    through ``generate``'s sampler, against softmax(lp / T), Pearson's
    chi-square below its 1 - 1e-6 quantile (40.52 at 7 degrees of
    freedom, 8 tokens), at T = 0.5, 0.8 and 2.0.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from distributed_mnist_bnns_tpu.infer_transformer import (
    generate as jax_generate,
)
from distributed_mnist_bnns_tpu_torch import cli
from distributed_mnist_bnns_tpu_torch.examples import lm_demo
from distributed_mnist_bnns_tpu_torch.infer_transformer import generate
from distributed_mnist_bnns_tpu_torch.interop import frozen_to_jax
from distributed_mnist_bnns_tpu_torch.utils import msgpack
from tests.torch_lm_util import frozen_pair

PROMPT = "ab"                      # tokens 97 % 32, 98 % 32 = 1, 2
CHI2_Q = 1 - 1e-6                  # the chi-square bound's quantile
N_DRAWS = 20000


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jfrozen, frozen = frozen_pair(seed=2)
    path = tmp_path_factory.mktemp("lm_sample") / "lm.msgpack"
    path.write_bytes(msgpack.msgpack_serialize(frozen_to_jax(frozen)))
    return jfrozen, frozen, str(path)


def _cli_tokens(capsys, path, *flags):
    assert cli.main(["lm", "--load", path, "--prompt", PROMPT,
                     "--device", "cpu", *flags]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "tokens"]


def test_greedy_cli_equals_jax_generate(pair, capsys):
    """``--temperature 0``: token for token the JAX package's greedy
    ``generate`` (the projections are exact integer sums on both sides;
    random non-zero biases leave no ties)."""
    jfrozen, _, path = pair
    got = _cli_tokens(capsys, path, "--sample", "20", "--temperature", "0")
    want = jax_generate(jfrozen, jnp.asarray([[1, 2]], jnp.int32), 20,
                        interpret=True)
    assert got == np.asarray(want)[0, 2:].tolist()


def test_sampling_is_the_default_and_repeats_from_its_seed(pair, capsys):
    """The default is JAX's: --temperature 0.8 (sampling), --sample 0
    meaning 64 tokens clamped to the window; one seed gives one
    sequence, and it is not the greedy one."""
    _, frozen, path = pair
    args = cli.build_parser().parse_args(["lm", "--load", path])
    assert (args.temperature, args.sample) == (0.8, 0)
    a = _cli_tokens(capsys, path, "--seed", "5")
    b = _cli_tokens(capsys, path, "--seed", "5")
    c = _cli_tokens(capsys, path, "--seed", "6")
    assert a == b and len(a) == 30          # max_len 32 - the prompt
    greedy = _cli_tokens(capsys, path, "--temperature", "0")
    assert a != greedy and a != c
    want = generate(frozen, [[1, 2]], 30, temperature=0.8, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    assert a == want[0, 2:].tolist()


def test_cli_refuses_negative_sample_and_temperature(pair):
    _, _, path = pair
    with pytest.raises(SystemExit, match="--sample must be"):
        cli.main(["lm", "--load", path, "--sample", "-1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--temperature must be"):
        cli.main(["lm", "--load", path, "--temperature", "-0.5",
                  "--device", "cpu"])


def _fixed_row_decoder(lp_row: torch.Tensor):
    """A decoder whose every step returns ``lp_row`` for each batch row:
    ``generate``'s sampler then draws once a row from the same row."""

    def init(batch):
        return None

    def step(caches, tokens, pos):
        return caches, lp_row.expand(len(tokens), -1).clone()

    step.cache_len = 8
    return init, step


@pytest.mark.parametrize("temperature", [0.5, 0.8, 2.0])
def test_sampled_distribution_is_softmax_over_temperature(temperature):
    lp = torch.log_softmax(torch.tensor(
        [1.3, -0.4, 0.2, 2.1, -1.7, 0.0, 0.9, -0.2]), dim=-1)
    out = generate({}, np.zeros((N_DRAWS, 1), np.int64), 1,
                   temperature=temperature,
                   generator=torch.Generator().manual_seed(11),
                   decoder=_fixed_row_decoder(lp))
    counts = np.bincount(out[:, 1].numpy(), minlength=len(lp))
    want = torch.softmax(lp / temperature, dim=-1).double().numpy() * N_DRAWS
    stat = float(((counts - want) ** 2 / want).sum())
    assert stat < chi2.ppf(CHI2_Q, len(lp) - 1), (stat, counts, want)


def test_lm_demo_samples_after_training(capsys):
    """``run(sample=N)`` draws N tokens from the trained model over the
    sliding window: greedy equals the argmax of the model's own forward
    window by window; a temperature run repeats from its seed; ``cli lm
    --steps --sample`` reports them."""
    kw = dict(steps=2, seq_len=16, batch=2, vocab=32, embed_dim=32,
              depth=2, num_heads=2, device="cpu", log_every=1, seed=3)
    res = lm_demo.run(sample=6, temperature=0.0, **kw)
    _, draw = lm_demo.token_stream(16, 2, 32, 3)
    window = torch.from_numpy(draw()[0])
    want = []
    with torch.no_grad():
        for _ in range(6):
            tok = int(res.model.eval()(window[None])[0, -1].argmax())
            want.append(tok)
            window = torch.cat([window[1:], torch.tensor([tok])])
    assert res.sample == want
    a = lm_demo.run(sample=6, temperature=0.8, **kw).sample
    b = lm_demo.run(sample=6, temperature=0.8, **kw).sample
    assert a == b and len(a) == 6
    capsys.readouterr()
    assert cli.main(["lm", "--steps", "2", "--seq-len", "16", "--batch-size",
                     "2", "--vocab", "32", "--embed-dim", "32", "--depth",
                     "2", "--num-heads", "2", "--seed", "3", "--attention",
                     "xla", "--device", "cpu", "--sample", "6",
                     "--temperature", "0"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["sample"] == want
