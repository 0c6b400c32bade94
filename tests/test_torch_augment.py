"""The port's device-side augmentation (``ops/augment.py``, the train
step's ``augment``) against the JAX package's ``random_crop_flip``.

``crop_flip`` is a gather: on JAX's own draws (its key split into ky,
kx, kf, then ``randint`` and ``bernoulli``, recomputed here) it is JAX's
output bitwise, at every shape tried and on values a computation would
change (-0.0, NaN, ±inf, subnormals). The draws come from a
``torch.Generator``, not JAX's PRNG, so they are held by their law
instead: offsets uniform on [0, 8], a fair coin (counts within 5
standard deviations over 36,000 draws). An augmented step is the plain
step on the cropped batch, bitwise; it changes the trajectory. Under
data parallelism on 2 gloo ranks the GSPMD step draws the global
batch's crops (every rank the same draws, keeping its rows: the single
process's crops of the whole batch) and the compressed step each
rank's own.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.ops.augment import random_crop_flip as jcrop
from distributed_mnist_bnns_tpu_torch.models import get_model, latent_clamp_mask
from distributed_mnist_bnns_tpu_torch.ops.augment import (
    crop_flip,
    draw_crop_flip,
    random_crop_flip,
)
from distributed_mnist_bnns_tpu_torch.parallel import rank_seed, spawn
from distributed_mnist_bnns_tpu_torch.train import (
    make_optimizer,
    make_step_body,
)
from tests import torch_augment_util as util


def _jax_draws(key, b, pad=4):
    """JAX's own (oy, ox, flip) of ``random_crop_flip(images, key)``."""
    ky, kx, kf = jax.random.split(key, 3)
    oy = jax.random.randint(ky, (b,), 0, 2 * pad + 1)
    ox = jax.random.randint(kx, (b,), 0, 2 * pad + 1)
    flip = jax.random.bernoulli(kf, 0.5, (b,))
    return (torch.from_numpy(np.asarray(v).copy()) for v in (oy, ox, flip))


def _images(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:6] = [-0.0, np.nan, np.inf, -np.inf, 1e-40, -1e-45]
    return x


@pytest.mark.parametrize("shape", [(8, 32, 32, 3), (5, 28, 28, 1),
                                   (3, 7, 5, 2), (1, 64, 64, 3)])
@pytest.mark.parametrize("seed", [0, 11])
def test_crop_flip_is_jax_bitwise_on_jax_draws(shape, seed):
    x = _images(shape, seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jcrop(jnp.asarray(x), key))
    got = crop_flip(torch.from_numpy(x), *_jax_draws(key, shape[0])).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_crop_flip_geometry():
    """Offset (4, 4) unflipped is the identity; (0, 0) shifts the image
    down-right by 4 behind zeros; a flip mirrors W."""
    x = torch.arange(2 * 6 * 5 * 1, dtype=torch.float32).reshape(2, 6, 5, 1)
    four = torch.tensor([4, 4])
    assert torch.equal(crop_flip(x, four, four, torch.tensor([False] * 2)),
                       x)
    assert torch.equal(crop_flip(x, four, four, torch.tensor([True] * 2)),
                       x.flip(2))
    zero = torch.zeros(2, dtype=torch.long)
    out = crop_flip(x, zero, zero, torch.tensor([False, False]))
    assert torch.equal(out[:, 4:, 4:], x[:, :2, :1])
    assert torch.equal(out[:, :4], torch.zeros_like(out[:, :4]))
    with pytest.raises(ValueError, match="B, H, W, C"):
        crop_flip(x.reshape(2, -1), zero, zero, zero.bool())


def test_draws_are_uniform_offsets_and_a_fair_coin():
    n = 36000
    oy, ox, flip = draw_crop_flip(n, torch.Generator().manual_seed(3))
    assert oy.dtype == ox.dtype == torch.int64 and flip.dtype == torch.bool
    for o in (oy, ox):
        assert int(o.min()) == 0 and int(o.max()) == 8
        counts = torch.bincount(o, minlength=9).double()
        sd = (n * (1 / 9) * (8 / 9)) ** 0.5
        assert float((counts - n / 9).abs().max()) <= 5 * sd
    assert abs(float(flip.double().sum()) - n / 2) <= 5 * (n / 4) ** 0.5
    assert not torch.equal(oy, ox)
    # one generator state, one set of draws
    again = draw_crop_flip(n, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip((oy, ox, flip), again))


def _resnet(seed=0):
    return get_model("xnor-resnet18", stem_features=4, backend="xla",
                     rng_seed=7, generator=torch.Generator().manual_seed(seed))


def test_augmented_step_is_the_plain_step_on_the_crops():
    x = torch.from_numpy(np.random.RandomState(1).rand(8, 16, 16, 3)
                         .astype(np.float32))
    y = torch.arange(8) % 10
    a, b, c = _resnet(), _resnet(), _resnet()
    steps = {m: (make_step_body(latent_clamp_mask(m), augment=aug),
                 make_optimizer("sgd", m.parameters(), 0.05))
             for m, aug in ((a, True), (b, False), (c, False))}
    gen = torch.Generator().manual_seed(7)   # model a's train generator
    for _ in range(2):
        la, _ = steps[a][0](a, steps[a][1], x, y)
        lb, _ = steps[b][0](b, steps[b][1], random_crop_flip(x, gen), y)
        steps[c][0](c, steps[c][1], x, y)
        assert torch.equal(la, lb)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.stem.weight, c.stem.weight)
    assert torch.equal(a.train_generator(torch.device("cpu")).get_state(),
                       gen.get_state())


# the two registered models that draw nothing themselves: their crops come
# from the generator of their own that ``rng_seed`` seeds
NO_DRAW_MODELS = {
    "convnet": ((8, 28, 28, 1), {}),
    "bnn-moe-mlp": ((8, 28, 28, 1),
                    {"hidden": 32, "num_experts": 4, "expert_features": 32,
                     "backend": "xla"}),
}


@pytest.mark.parametrize("name", sorted(NO_DRAW_MODELS))
def test_augmented_step_of_a_model_that_draws_nothing_is_the_plain_step(
        name):
    """``convnet`` and ``bnn-moe-mlp`` augment as every other model does:
    the augmented step is the plain step on ``random_crop_flip``'s crops
    from the model's own generator (``rng_seed``), bitwise, loss, every
    parameter and statistic and the generator's state."""
    shape, kw = NO_DRAW_MODELS[name]
    x = torch.from_numpy(np.random.RandomState(2).rand(*shape)
                         .astype(np.float32))
    y = torch.arange(shape[0]) % 10

    def model():
        return get_model(name, rng_seed=7,
                         generator=torch.Generator().manual_seed(0), **kw)

    a, b, c = model(), model(), model()
    steps = {m: (make_step_body(latent_clamp_mask(m), augment=aug),
                 make_optimizer("sgd", m.parameters(), 0.05))
             for m, aug in ((a, True), (b, False), (c, False))}
    gen = torch.Generator().manual_seed(7)   # model a's train generator
    for _ in range(2):
        la, _ = steps[a][0](a, steps[a][1], x, y)
        lb, _ = steps[b][0](b, steps[b][1], random_crop_flip(x, gen), y)
        steps[c][0](c, steps[c][1], x, y)
        assert torch.equal(la, lb)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert any(not torch.equal(va, vc) for va, vc in
               zip(a.state_dict().values(), c.state_dict().values()))
    assert torch.equal(a.train_generator(torch.device("cpu")).get_state(),
                       gen.get_state())


@pytest.mark.parametrize("mode", [dict(scan_steps=2), dict(device_data=True)],
                         ids=["scan", "device_data"])
@pytest.mark.parametrize("name", sorted(NO_DRAW_MODELS))
def test_augmented_dispatch_of_a_model_that_draws_nothing(name, mode):
    """The captured dispatch (``scan_steps``, ``device_data``) of
    ``convnet`` and ``bnn-moe-mlp`` under ``augment``: bitwise the
    per-step path (parameters, statistics, generator), and not the path
    without ``augment``."""
    from distributed_mnist_bnns_tpu_torch.data import ImageClassData
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    _, kw = NO_DRAW_MODELS[name]
    rng = np.random.RandomState(3)
    data = ImageClassData(rng.rand(24, 28, 28, 1).astype(np.float32),
                          rng.randint(0, 10, 24).astype(np.int32),
                          rng.rand(16, 28, 28, 1).astype(np.float32),
                          rng.randint(0, 10, 16).astype(np.int32),
                          source="synthetic")
    common = dict(model=name, model_kwargs=dict(kw), batch_size=8, epochs=1,
                  optimizer="sgd", learning_rate=0.05, seed=5,
                  device="cpu")
    runs = [Trainer(TrainConfig(**common, augment=True, **mode)),
            Trainer(TrainConfig(**common, augment=True)),
            Trainer(TrainConfig(**common))]
    for t in runs:
        t.fit(data, eval_every=0)
    captured, step, plain = (t.model.state_dict() for t in runs)
    for k in step:
        assert torch.equal(captured[k], step[k]), k
    assert any(not torch.equal(step[k], plain[k]) for k in step)
    gens = [t.model.train_generator(torch.device("cpu")).get_state()
            for t in runs]
    assert torch.equal(gens[0], gens[1])
    assert not torch.equal(gens[1], gens[2])


@functools.lru_cache(maxsize=None)
def _dp_run():
    rng = np.random.RandomState(5)
    images = rng.rand(8, 16, 16, 3).astype(np.float32)
    labels = rng.randint(0, 10, 8).astype(np.int32)
    mnist = rng.rand(8, 28, 28, 1).astype(np.float32)
    mnist_labels = rng.randint(0, 10, 8).astype(np.int32)
    return images, labels, spawn(util.augment_rank, 2, backend="gloo",
                                 device="cpu",
                                 args=(images, labels, 43, mnist,
                                       mnist_labels))


def test_gspmd_draws_the_global_batch_and_compressed_each_shard():
    images, _, ranks = _dp_run()
    x = torch.from_numpy(images)
    want = random_crop_flip(x, torch.Generator().manual_seed(43)).numpy()
    got = np.concatenate([r["global"] for r in ranks])
    assert got.tobytes() == want.tobytes()
    for r, out in enumerate(ranks):
        rows = x[r * 4:(r + 1) * 4]
        mine = random_crop_flip(rows, torch.Generator().manual_seed(
            rank_seed(43, r))).numpy()
        assert out["per_shard"].tobytes() == mine.tobytes()
    assert ranks[0]["per_shard"].tobytes() != want[:4].tobytes()


def test_the_trainer_picks_each_exchange_its_draws():
    """``Trainer`` at dp 2: the GSPMD step's crops from ``seed + 1`` on
    every rank, the compressed (``sign_ef``) step's from each rank's own
    generator; one augmented step of each runs to a finite loss, the
    same on both ranks."""
    _, _, ranks = _dp_run()
    for r, out in enumerate(ranks):
        assert out["none"]["augment_seed"] == 43
        assert out["sign_ef"]["augment_seed"] is None
        assert out["sign_ef"]["rng_seed"] == rank_seed(43, r)
    for gc in ("none", "sign_ef"):
        assert np.isfinite(ranks[0][gc]["loss"])
        assert ranks[0][gc]["loss"] == ranks[1][gc]["loss"]


@pytest.mark.parametrize("name", sorted(NO_DRAW_MODELS))
def test_the_trainer_picks_each_exchange_its_draws_for_models_that_draw_nothing(
        name):
    """``convnet`` and ``bnn-moe-mlp`` under ``augment`` at dp 2, as the
    resnet: the GSPMD step draws from ``seed + 1`` on every rank, the
    compressed step from each rank's own generator; one augmented step
    of each runs to a finite loss, the same on both ranks."""
    _, _, ranks = _dp_run()
    for r, out in enumerate(ranks):
        assert out[name]["none"]["augment_seed"] == 43
        assert out[name]["sign_ef"]["augment_seed"] is None
        assert out[name]["sign_ef"]["rng_seed"] == rank_seed(43, r)
    for gc in ("none", "sign_ef"):
        assert np.isfinite(ranks[0][name][gc]["loss"])
        assert ranks[0][name][gc]["loss"] == ranks[1][name][gc]["loss"]
