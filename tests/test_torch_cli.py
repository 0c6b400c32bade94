"""The PyTorch port's command line: ``export`` then ``infer`` on the CPU,
``train`` -> ``eval`` -> ``export --checkpoint-dir`` -> ``infer``, and
the default device that never falls back to it."""

import json

import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu_torch import cli
from distributed_mnist_bnns_tpu_torch.data import (
    load_idx,
    load_mnist,
    synthetic_blobs,
)
from distributed_mnist_bnns_tpu_torch.infer import load_frozen, load_packed


def test_export_then_infer_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "m.msgpack")
    assert cli.main(["export", "--model", "bnn-mlp-small", "--infl-ratio",
                     "1", "--seed", "3", "--out", out]) == 0
    exported = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert exported["artifact"] == out and exported["family"] == "bnn-mlp"
    fn, info = load_packed(out, device="cpu")
    assert info["compression"] == exported["compression"]
    assert cli.main(["infer", "--artifact", out, "--device", "cpu",
                     "--batch-size", "16", "--synthetic-sizes", "8", "40",
                     "--data-dir", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["n_examples"] == 40 and res["data_source"] == "synthetic"
    assert res["device"] == "cpu" and 0.0 <= res["test_acc"] <= 100.0


def test_export_from_jax_variables_npz(tmp_path, capsys):
    """--jax-variables loads a '/'-keyed .npz of the JAX tree."""
    rng = np.random.RandomState(0)
    flat = {}
    dims = (784, 64, 64, 64)
    for i in range(3):
        flat[f"params/BinarizedDense_{i}/kernel"] = rng.randn(
            dims[i], dims[i + 1]).astype(np.float32)
        flat[f"params/BinarizedDense_{i}/bias"] = np.zeros(64, np.float32)
        flat[f"params/BatchNorm_{i}/scale"] = np.ones(64, np.float32)
        flat[f"params/BatchNorm_{i}/bias"] = np.zeros(64, np.float32)
        flat[f"batch_stats/BatchNorm_{i}/mean"] = np.zeros(64, np.float32)
        flat[f"batch_stats/BatchNorm_{i}/var"] = np.ones(64, np.float32)
    flat["params/Dense_0/kernel"] = rng.randn(64, 10).astype(np.float32)
    flat["params/Dense_0/bias"] = np.zeros(10, np.float32)
    npz = tmp_path / "vars.npz"
    np.savez(npz, **flat)
    out = str(tmp_path / "m.msgpack")
    assert cli.main(["export", "--jax-variables", str(npz),
                     "--out", out]) == 0
    frozen = load_frozen(out)
    np.testing.assert_array_equal(
        frozen["w1"].numpy(),
        np.where(flat["params/BinarizedDense_0/kernel"] >= 0, 1, -1),
    )


def test_device_defaults_to_cuda(tmp_path):
    args = cli.build_parser().parse_args(["serve", "--artifact", "x"])
    assert args.device == "cuda"
    args = cli.build_parser().parse_args(["infer", "--artifact", "x"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["infer", "--artifact", str(tmp_path / "absent.msgpack")])


def test_mnist_loader_parses_idx_and_falls_back(tmp_path):
    imgs = (np.arange(2 * 28 * 28) % 256).astype(np.uint8).reshape(2, 28, 28)
    labels = np.array([3, 7], np.uint8)
    for stem, arr, magic in (("t10k-images-idx3-ubyte", imgs, 0x0803),
                             ("t10k-labels-idx1-ubyte", labels, 0x0801)):
        with open(tmp_path / stem, "wb") as f:
            f.write(magic.to_bytes(4, "big"))
            for d in arr.shape:
                f.write(int(d).to_bytes(4, "big"))
            f.write(arr.tobytes())
    np.testing.assert_array_equal(
        load_idx(str(tmp_path / "t10k-images-idx3-ubyte")), imgs
    )
    data = load_mnist(str(tmp_path), norm="none")
    assert data.source == "t10k-split" and data.test_images.shape[1:] == (
        28, 28, 1)
    empty = tmp_path / "empty"
    empty.mkdir()
    syn = load_mnist(str(empty), synthetic_sizes=(6, 4), seed=1)
    assert syn.source == "synthetic" and syn.test_images.shape == (4, 28, 28, 1)
    with pytest.raises(FileNotFoundError):
        load_mnist(str(empty), synthetic_ok=False)


def test_synthetic_blobs_match_the_jax_package():
    from distributed_mnist_bnns_tpu.data.common import (
        synthetic_blobs as jax_blobs,
    )

    for a, b in zip(synthetic_blobs((28, 28), 5, 3, seed=2),
                    jax_blobs((28, 28), 5, 3, seed=2)):
        np.testing.assert_array_equal(a, b)


_TINY_LM = ["--vocab", "32", "--max-len", "32", "--embed-dim", "32",
            "--depth", "2", "--num-heads", "2"]


def test_lm_export_then_sample_on_cpu(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.infer_transformer import generate

    out = str(tmp_path / "lm.msgpack")
    assert cli.main(["lm", "--export", out, "--seed", "1", *_TINY_LM]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["kind"] == "lm" and info["family"] == "bnn-transformer"
    assert cli.main(["lm", "--load", out, "--sample", "6", "--prompt", "ab",
                     "--temperature", "0", "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = generate(load_frozen(out), [[97 % 32, 98 % 32]], 6, device="cpu")
    assert res["tokens"] == want[0, 2:].tolist()


def test_lm_export_from_jax_variables_npz(tmp_path, capsys):
    """--jax-variables loads a '/'-keyed .npz of the JAX LM's params; the
    packed words equal the JAX package's freeze of the same tree."""
    import jax

    from distributed_mnist_bnns_tpu.infer_transformer import (
        _freeze_lm_tensors,
    )
    from tests.torch_lm_util import jax_lm, numpy_params

    jm = jax_lm()
    params = numpy_params(jm, seed=4)
    flat = {
        "params/" + "/".join(p.key for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    npz = tmp_path / "lm.npz"
    np.savez(npz, **flat)
    out = str(tmp_path / "lm.msgpack")
    assert cli.main(["lm", "--export", out, "--jax-variables", str(npz),
                     "--num-heads", "2"]) == 0
    frozen = load_frozen(out)
    want = _freeze_lm_tensors(jm, {"params": params})
    np.testing.assert_array_equal(frozen["blocks"][1]["mlp2"]["wp"].numpy(),
                                  np.asarray(want["blocks"][1]["mlp2"]["wp"]))
    assert frozen["info"] == want["info"]


def test_lm_train_then_export_then_sample_on_cpu(tmp_path, capsys):
    """``lm --steps N --export`` trains (flash attention by default) and
    freezes the trained model; ``lm --load`` samples from it."""
    from distributed_mnist_bnns_tpu_torch.infer_transformer import generate

    out = str(tmp_path / "lm.msgpack")
    assert cli.main(["lm", "--steps", "2", "--export", out, "--seq-len",
                     "16", "--batch-size", "2", "--device", "cpu",
                     *_TINY_LM]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["steps"] == 2 and len(res["loss_history"]) == 2
    assert res["artifact"] == out and res["kind"] == "lm"
    frozen = load_frozen(out)
    assert frozen["pos_embed"].shape[1] == 16   # max_len = seq_len
    untrained = str(tmp_path / "init.msgpack")
    assert cli.main(["lm", "--export", untrained, "--max-len", "16",
                     *_TINY_LM]) == 0
    capsys.readouterr()
    assert not torch.equal(load_frozen(untrained)["head_w"],
                           frozen["head_w"])
    assert cli.main(["lm", "--load", out, "--sample", "4", "--prompt", "ab",
                     "--temperature", "0", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = generate(frozen, [[97 % 32, 98 % 32]], 4, device="cpu")
    assert got["tokens"] == want[0, 2:].tolist()


def test_lm_refuses_training_and_serve_lm_defaults_to_cuda(tmp_path):
    """Training refuses what it cannot do (a negative count, --load or
    --jax-variables with --steps) and, without a card, the default
    device; ``serve --lm`` defaults to cuda too."""
    with pytest.raises(SystemExit, match="--steps must be"):
        cli.main(["lm", "--steps", "-1"])
    with pytest.raises(SystemExit, match="neither --load"):
        cli.main(["lm", "--steps", "2", "--load", str(tmp_path / "x.msgpack")])
    args = cli.build_parser().parse_args(["lm", "--steps", "3"])
    assert args.device == "cuda" and args.attention == "flash"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["lm", "--steps", "1", *_TINY_LM])
    args = cli.build_parser().parse_args(
        ["serve", "--lm", "--artifact", "x"])
    assert args.lm and args.device == "cuda" and args.slots == 4
    assert (args.page_size, args.prefill_chunk) == (16, 16)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--lm", "--artifact", str(tmp_path / "x.msgpack")])


_TRAIN_SMALL = ["--model", "bnn-mlp-small", "--infl-ratio", "1",
                "--synthetic-sizes", "512", "128", "--seed", "3"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_eval_export_infer_on_cpu(tmp_path, capsys):
    """``train --checkpoint-dir`` prints its final metrics as one JSON
    line; ``eval`` reads the same checkpoint back to the same metrics;
    ``export --checkpoint-dir`` freezes the trained model into the
    packed artifact, which ``infer`` serves to the same accuracy."""
    ckpt = str(tmp_path / "ckpt")
    data_dir = str(tmp_path / "no-idx")
    assert cli.main(["train", *_TRAIN_SMALL, "--epochs", "2",
                     "--batch-size", "64", "--device", "cpu",
                     "--log-interval", "4", "--checkpoint-dir", ckpt,
                     "--data-dir", data_dir]) == 0
    trained = _last_json(capsys)
    assert trained["total_steps"] == 2 * (512 // 64) == 2 * trained["steps"]
    assert trained["epoch"] == 1
    assert trained["device"] == "cpu" and trained["data_source"] == \
        "synthetic"
    assert np.isfinite(trained["train_loss"]) and trained["test_acc"] > 50
    assert cli.main(["eval", *_TRAIN_SMALL, "--device", "cpu",
                     "--checkpoint-dir", ckpt, "--data-dir", data_dir]) == 0
    evaluated = _last_json(capsys)
    for k in ("test_loss", "test_acc", "test_acc_top5"):
        assert evaluated[k] == trained[k], k
    assert evaluated["checkpoint_step"] == trained["total_steps"]
    out = str(tmp_path / "trained.msgpack")
    assert cli.main(["export", "--model", "bnn-mlp-small", "--infl-ratio",
                     "1", "--checkpoint-dir", ckpt, "--best",
                     "--out", out]) == 0
    assert _last_json(capsys)["family"] == "bnn-mlp"
    assert cli.main(["infer", "--artifact", out, "--device", "cpu",
                     "--synthetic-sizes", "512", "128",
                     "--data-dir", data_dir]) == 0
    served = _last_json(capsys)
    assert served["n_examples"] == 128
    assert abs(served["test_acc"] - trained["best_acc"]) <= 100.0 / 128


def test_train_defaults_and_refusals(tmp_path):
    """The JAX CLI's defaults; without a card the default device
    raises; ``eval`` needs a checkpoint and ``export`` takes one source
    of weights, of the model it names."""
    args = cli.build_parser().parse_args(["train"])
    assert (args.model, args.epochs, args.batch_size, args.lr) == (
        "bnn-mlp-large", 5, 64, 0.01)
    assert (args.optimizer, args.seed, args.loss, args.device) == (
        "adam", 42, "ce", "cuda")
    assert args.backend is None and args.dropout is None
    with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
        cli.main(["eval", "--device", "cpu"])
    with pytest.raises(SystemExit, match="at most one"):
        cli.main(["export", "--checkpoint-dir", str(tmp_path),
                  "--jax-variables", "x.npz"])
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(["train", *_TRAIN_SMALL, "--epochs", "1",
                     "--synthetic-sizes", "64", "64", "--device", "cpu",
                     "--checkpoint-dir", ckpt,
                     "--data-dir", str(tmp_path / "none")]) == 0
    with pytest.raises(SystemExit, match="holds a"):
        cli.main(["export", "--checkpoint-dir", ckpt, "--out",
                  str(tmp_path / "m.msgpack")])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", *_TRAIN_SMALL, "--epochs", "1"])


def test_train_dispatch_flags_on_cpu(tmp_path, capsys):
    """``--scan-steps``, ``--device-data``, ``--grad-accum`` and
    ``--remat`` (the JAX CLI's) reach the trainer: the first two train
    the same model as the per-step loop (on the CPU a dispatch runs its
    steps eagerly), the device-data run in one dispatch with its eval on
    the device; a batch that ``--grad-accum`` does not divide is
    refused."""
    args = cli.build_parser().parse_args(["train"])
    assert (args.scan_steps, args.device_data, args.grad_accum,
            args.remat) == (1, False, 1, False)
    base = ["train", "--model", "bnn-mlp-small", "--infl-ratio", "1",
            "--synthetic-sizes", "256", "64", "--seed", "3", "--epochs", "1",
            "--batch-size", "32", "--device", "cpu",
            "--data-dir", str(tmp_path / "none")]
    rows = {}
    for name, extra in (("eager", []), ("scan", ["--scan-steps", "3"]),
                        ("device", ["--device-data"]),
                        ("remat", ["--remat"]),
                        ("accum", ["--grad-accum", "4"])):
        assert cli.main(base + extra) == 0
        rows[name] = _last_json(capsys)
    eager = rows["eager"]
    for name in ("scan", "remat"):
        for k in ("test_loss", "test_acc", "test_acc_top5", "total_steps"):
            assert rows[name][k] == eager[k], (name, k)
    dev = rows["device"]
    assert dev["dispatches"] == 1 and dev["total_steps"] == 256 // 32
    assert dev["test_acc"] == eager["test_acc"]
    np.testing.assert_allclose(dev["test_loss"], eager["test_loss"],
                               rtol=1e-5)
    assert rows["accum"]["total_steps"] == 256 // 32
    assert np.isfinite(rows["accum"]["train_loss"])
    with pytest.raises(SystemExit, match="not divisible by --grad-accum"):
        cli.main(base + ["--batch-size", "30", "--grad-accum", "4"])


def _jax_model_kwargs(argv, monkeypatch):
    """The model kwargs the JAX CLI's ``_make_trainer`` builds for
    ``argv`` (its Trainer replaced by a stub that keeps the config)."""
    import distributed_mnist_bnns_tpu.train as jtrain
    from distributed_mnist_bnns_tpu import cli as jcli

    class Stub:
        def __init__(self, config, input_shape=None):
            self.config = config

    monkeypatch.setattr(jtrain, "Trainer", Stub)
    return jcli._make_trainer(jcli.build_parser().parse_args(argv)
                              ).config.model_kwargs


@pytest.mark.parametrize("name", ["bnn-cnn", "bnn-mlp-large",
                                  "bnn-mlp-small", "bnn-moe-mlp",
                                  "bnn-vit-small", "bnn-vit-tiny", "convnet",
                                  "deep-cnn", "fp32-mlp-large",
                                  "fp32-resnet18", "fp32-vit-small",
                                  "fp32-vit-tiny", "qnn-mlp-large",
                                  "xnor-resnet18", "xnor-resnet50"])
def test_model_kwargs_are_jax_rule(name, monkeypatch):
    """For every registry model the flags give the JAX CLI's kwargs:
    ``--infl-ratio`` reaches the bnn-mlp family only, ``--dropout`` the
    transformers as ``dropout``; for any other model it exits (the JAX
    builder drops it)."""
    from distributed_mnist_bnns_tpu.models import get_model as jget

    for extra in (["--infl-ratio", "1"], ["--dropout", "0.1"]):
        argv = ["train", "--model", name, *extra]
        want = _jax_model_kwargs(argv, monkeypatch)
        args = cli.build_parser().parse_args(argv)
        if "dropout" in want:
            try:
                jget(name, dropout=0.1)
            except TypeError:
                with pytest.raises(SystemExit, match="reference-fixed"):
                    cli._model_kwargs(args)
                continue
        assert cli._model_kwargs(args) == want


def _registry():
    from distributed_mnist_bnns_tpu_torch.models import list_models

    return list_models()


def test_registry_is_covered_by_the_kwargs_test():
    names = test_model_kwargs_are_jax_rule.pytestmark[0].args[1]
    assert sorted(names) == _registry()


def test_cli_train_vit_with_dropout(tmp_path, capsys):
    """``--dropout 0.1`` trains bnn-vit-tiny (the JAX CLI's rate); on an
    MLP it exits with a message."""
    common = ["--epochs", "1", "--batch-size", "16", "--synthetic-sizes",
              "32", "16", "--device", "cpu", "--data-dir",
              str(tmp_path / "none")]
    assert cli.main(["train", "--model", "bnn-vit-tiny", "--dropout", "0.1",
                     *common]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["model"] == "bnn-vit-tiny" and np.isfinite(row["train_loss"])
    with pytest.raises(SystemExit, match="reference-fixed"):
        cli.main(["train", "--model", "bnn-mlp-small", "--dropout", "0.1",
                  *common])


def test_fp32_mlp_keeps_jax_widths_under_infl_ratio():
    """``--infl-ratio 1`` does not reach fp32-mlp-large: 784 -> 3072 ->
    1536 -> 768 -> 10, as the JAX CLI builds it."""
    from distributed_mnist_bnns_tpu_torch.models import get_model

    args = cli.build_parser().parse_args(
        ["train", "--model", "fp32-mlp-large", "--infl-ratio", "1"])
    model = get_model("fp32-mlp-large", **cli._model_kwargs(args))
    assert model.hidden == (3072, 1536, 768)
