"""Train the causal binarized LM on a synthetic corpus or a real text file.

Counterpart of the JAX package's ``examples/lm_demo.py::run``: next-token
training of ``BinarizedLM`` with ``lm_loss``, Adam and the latent clamp
after every step, optionally with the flash-attention kernels
(``attention="flash"``). Reached from the command line as
``python -m distributed_mnist_bnns_tpu_torch.cli lm --steps N``.

Data: ``corpus=FILE`` trains byte-level (vocab 256) on random windows of
the file; without it a periodic synthetic corpus (predictable, so the
loss falls fast) stands in. Both come from ``np.random.RandomState(seed)``
exactly as in the JAX package, so the two see the same batches; the
weights are drawn from a ``torch.Generator`` and differ.

``pp=N`` trains the model-level GPipe pipeline over the block stack
(``parallel.pipeline_model``, JAX's ``run(pp=N)``): N ranks, one a card
over NCCL (``--pp N needs N devices`` with fewer cards; on the CPU, or
with ``backend="gloo"`` on one card, gloo ranks), ``n_micro = pp``, each
rank building the same seeded model and keeping its stage's blocks. The
returned model is the trained one gathered from the stages, and
``ranks`` each rank's history and launch counts of the hand-written
kernels.

Not here yet: sequence-parallel ring attention (``ring``, ROADMAP queue 1
item 14) raises; sampling after training goes through ``cli lm --load
PATH --sample N`` on the exported artifact.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..infer import export_packed, resolve_device
from ..models import BinarizedLM, latent_clamp_mask, lm_loss
from ..train import clamp_latent


class LMRun(NamedTuple):
    history: List[float]     # the loss at each log_every and at the end
    model: BinarizedLM       # the trained model, on the run's device (on
                             # the CPU after a pipelined run)
    export: Optional[dict]   # export_packed's info, when exported
    ranks: Optional[List[dict]] = None  # a pipelined run's ranks: history,
                             # kernel launches (ops._kernels.LAUNCHES)


def token_stream(seq_len: int, batch: int, vocab: int, seed: int,
                 corpus: Optional[str] = None
                 ) -> Tuple[int, Callable[[], np.ndarray]]:
    """(vocab, draw): ``draw()`` gives the next (batch, seq_len) int64
    batch, as the JAX package's ``run`` draws it: random byte windows of
    ``corpus`` (vocab 256), or the fixed periodic synthetic batch."""
    rng = np.random.RandomState(seed)
    if corpus is not None:
        with open(corpus, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8)
        if len(data) <= seq_len:
            raise ValueError(
                f"corpus {corpus!r} has {len(data)} bytes; need more than "
                f"seq_len={seq_len}"
            )

        def draw() -> np.ndarray:
            starts = rng.randint(0, len(data) - seq_len, size=batch)
            return np.stack([data[s:s + seq_len] for s in starts]).astype(
                np.int64)

        return 256, draw
    if seq_len < 4:
        raise ValueError(
            f"the synthetic corpus needs seq_len >= 4, got {seq_len}"
        )
    period = seq_len // 4
    base = rng.randint(0, vocab, (batch, period))
    reps = -(-seq_len // period)  # tile up, slice to exact length
    fixed = np.tile(base, (1, reps))[:, :seq_len].astype(np.int64)
    return vocab, lambda: fixed


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train_step(model: BinarizedLM, opt: torch.optim.Optimizer,
               latents: Iterable[torch.Tensor],
               tokens: torch.Tensor) -> torch.Tensor:
    """One step: forward, ``lm_loss``, backward, the optimizer, then the
    latent clamp (without it latents drift outside [-1, 1] and the
    binarization regime degrades). Returns the loss, not synchronised."""
    opt.zero_grad(set_to_none=True)
    loss = lm_loss(model(tokens), tokens)
    loss.backward()
    opt.step()
    clamp_latent(latents)
    return loss.detach()


def run(steps: int = 200, seq_len: int = 32, batch: int = 16,
        vocab: int = 64, embed_dim: int = 128, depth: int = 2,
        num_heads: int = 4, mlp_ratio: int = 2, scale: bool = False,
        lr: float = 3e-3, seed: int = 0, attention: str = "xla",
        ring: bool = False, log_every: int = 25,
        corpus: Optional[str] = None, pp: int = 1,
        export: Optional[str] = None, device="cuda",
        backend: Optional[str] = None) -> LMRun:
    """Train a ``BinarizedLM`` with ``max_len = seq_len`` for ``steps``
    steps on ``device`` (None: "cuda"; raises without a card, pass "cpu"
    to run there) and, with ``export``, freeze it to a packed artifact
    through ``infer.export_packed``. Products stay fp32 (TF32 off), as
    the reference computes. ``pp > 1``: the pipelined run of the module
    docstring, its ranks over ``backend`` (None: NCCL on the cards, gloo
    on the CPU)."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if export and (ring or pp > 1):
        raise ValueError("--export requires the plain model "
                         "(no --ring / --pp)")
    if ring and pp > 1:
        raise ValueError("--ring and --pp are mutually exclusive")
    if ring:
        raise NotImplementedError(
            "ring attention is not ported yet (ROADMAP queue 1 item 14, "
            "parallel/ring_attention.py)"
        )
    kw = dict(steps=steps, seq_len=seq_len, batch=batch, vocab=vocab,
              embed_dim=embed_dim, depth=depth, num_heads=num_heads,
              mlp_ratio=mlp_ratio, scale=scale, lr=lr, seed=seed,
              attention=attention, log_every=log_every, corpus=corpus)
    if pp > 1:
        return _run_pipelined(pp, kw, device, backend)
    dev = resolve_device(device)
    model, history = _train(dev, **kw)
    info = None
    if export:
        info = export_packed(model.eval(), export)
        print(f"packed artifact -> {export}: {info['compression']}x over "
              f"the fp32 latents ({info['frozen_weight_bytes']} packed "
              "bytes)")
    return LMRun(history, model, info)


def _train(dev: torch.device, *, steps, seq_len, batch, vocab, embed_dim,
           depth, num_heads, mlp_ratio, scale, lr, seed, attention,
           log_every, corpus, mesh=None, log: bool = True):
    """The training loop on ``dev``: the model (with ``mesh``, this
    rank's ``PipelinedModel``) and the logged losses."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vocab, draw = token_stream(seq_len, batch, vocab, seed, corpus)
    model = BinarizedLM(
        vocab=vocab, max_len=seq_len, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, mlp_ratio=mlp_ratio, scale=scale,
        attention=attention, generator=torch.Generator().manual_seed(seed),
    ).to(dev)
    if mesh is not None:
        from ..parallel import PipelinedModel

        model = PipelinedModel(model, mesh, n_micro=mesh.size("pipe"))
    latents = list(latent_clamp_mask(model).values())
    opt = make_optimizer(model, lr)
    history = []
    for i in range(steps):
        tokens = torch.from_numpy(draw()).to(dev)
        if mesh is None:
            loss = train_step(model, opt, latents, tokens)
        else:
            loss = _pp_step(model, opt, latents, tokens)
        if i % log_every == 0 or i == steps - 1:
            loss = float(loss)
            history.append(loss)
            if log:
                print(f"step {i:4d}  next-token loss {loss:.4f} "
                      f"({loss / float(np.log(2.0)):.3f} bits/token)")
    return model, history


def _pp_step(model, opt, latents, tokens) -> torch.Tensor:
    """``train_step`` over a pipelined model: the embedding's gradients
    summed over the pipe group before the update."""
    opt.zero_grad(set_to_none=True)
    loss = lm_loss(model(tokens), tokens)
    loss.backward()
    model.sync_grads()
    opt.step()
    clamp_latent(latents)
    return loss.detach()


def _pp_rank(rank: int, world: int, device, kw: dict) -> dict:
    """One stage of ``run(pp=world)``: the training, the full parameters
    gathered from the stages (flax layout, numpy) and this rank's kernel
    launches."""
    from ..ops import _kernels
    from ..parallel import Mesh
    from ..parallel.pipeline_model import sequential_params

    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    _kernels.reset_launches()
    mesh = Mesh((world,), ("pipe",))
    pm, history = _train(device, mesh=mesh, log=rank == 0, **kw)
    launches = dict(_kernels.LAUNCHES)
    tree = {k: _numpy(v) for k, v in pm.flax_params().items()}
    return {"history": history, "launches": launches,
            "params": sequential_params(tree, kw["depth"])}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _run_pipelined(pp: int, kw: dict, device, backend: Optional[str]
                   ) -> LMRun:
    from ..interop import lm_params_from_jax
    from ..parallel import spawn

    dev = resolve_device(device)
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if backend == "nccl" and torch.cuda.device_count() < pp:
        raise ValueError(f"--pp {pp} needs {pp} devices")
    ranks = spawn(_pp_rank, pp, backend=backend, device=dev.type,
                  args=(kw,))
    model = lm_params_from_jax(
        ranks[0]["params"], num_heads=kw["num_heads"], scale=kw["scale"],
        attention=kw["attention"])
    return LMRun(ranks[0]["history"], model, None, ranks)
