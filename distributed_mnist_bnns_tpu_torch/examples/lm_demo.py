"""Train the causal binarized LM on a synthetic corpus or a real text file.

Counterpart of the JAX package's ``examples/lm_demo.py::run``: next-token
training of ``BinarizedLM`` with ``lm_loss``, Adam and the latent clamp
after every step, optionally with the flash-attention kernels
(``attention="flash"``), then ``sample`` tokens drawn from the trained
model. Reached from the command line as
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

``ring`` trains with sequence-parallel causal ring attention
(``parallel.make_ring_attention``, the dense local step, as the JAX
package's ``run(ring=True)``): one rank per visible card, two gloo
ranks on the CPU. Every rank holds the whole model and draws
the same batches; it embeds its own shard of positions
(``seq_len`` over the ranks), its attention runs the ring over the group, and its
loss is its share of the global token mean (``ring_loss``), so the
gradients of the replicated parameters, summed over the group, are the
whole batch's (``ring_train_step``). The returned model is rank 0's.

``sample`` tokens follow the JAX package's sliding window: the window is
one more draw from the data stream, each token the greedy argmax
(``temperature`` 0) or a draw from softmax(lp / temperature) of the
window's last position, made with a CPU ``torch.Generator`` seeded from
``seed + 2``; the window then slides by one. JAX's PRNG bits are not
PyTorch's, so sampled tokens differ from the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..infer import export_packed, resolve_device
from ..models import BinarizedLM, latent_clamp_mask, lm_loss
from ..models.transformer import embed
from ..train import clamp_latent


class LMRun(NamedTuple):
    history: List[float]     # the loss at each log_every and at the end
    model: BinarizedLM       # the trained model, on the run's device (on
                             # the CPU after a pipelined run)
    export: Optional[dict]   # export_packed's info, when exported
    ranks: Optional[List[dict]] = None  # a pipelined or ring run's ranks:
                             # history, kernel launches (_kernels.LAUNCHES)
    sample: Optional[List[int]] = None  # tokens sampled after training


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


def ring_loss(model: BinarizedLM, tokens: torch.Tensor, group=None
              ) -> torch.Tensor:
    """This rank's share of ``lm_loss`` over the whole (B, L) batch
    ``tokens`` when the model's attention is a ring over ``group`` (None:
    the default group): the rank embeds positions ``[r * L/n, (r + 1) *
    L/n)``, runs the blocks on them and scores each position's next
    token (the shard's last one is the next shard's first), divided by
    the global count B * (L - 1). The shares sum to the whole loss."""
    group = group if group is not None else dist.group.WORLD
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b, length = tokens.shape
    if length % n:
        raise ValueError(f"seq_len {length} not divisible by {n} ranks")
    lo, hi = r * (length // n), (r + 1) * (length // n)
    x = embed(tokens[:, lo:hi], model.tok_embed.weight) \
        + model.pos_embed[:, lo:hi]
    gen = model.train_generator(x.device) if model.training else None
    for blk in model.blocks:
        x = blk(x, gen)
    targets = tokens[:, lo + 1:hi + 1].long()
    lp = model.head_out(x)[:, :targets.shape[1]]
    return -lp.gather(-1, targets[..., None]).sum() / (b * (length - 1))


def ring_train_step(model: BinarizedLM, opt: torch.optim.Optimizer,
                    latents: Iterable[torch.Tensor], tokens: torch.Tensor,
                    group=None) -> torch.Tensor:
    """``train_step`` under sequence parallelism: ``ring_loss``, its
    backward (the ring's exchanges reversed), the gradients and the loss
    summed over ``group`` in one all-reduce, the optimizer and the
    clamp. Returns the global loss."""
    group = group if group is not None else dist.group.WORLD
    opt.zero_grad(set_to_none=True)
    loss = ring_loss(model, tokens, group)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach()[None]])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat[:-1].split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
    opt.step()
    clamp_latent(latents)
    return flat[-1]


def sample_tokens(model: BinarizedLM, window: np.ndarray, n: int,
                  temperature: float,
                  generator: torch.Generator) -> List[int]:
    """``n`` tokens from the live ``model`` over a sliding ``window``
    (seq_len,) of tokens: greedy at ``temperature`` 0, else drawn from
    softmax(lp / temperature) with ``generator`` (CPU)."""
    dev = model.pos_embed.device
    window = torch.as_tensor(np.asarray(window), dtype=torch.int64)
    out: List[int] = []
    was_training = model.training
    model.eval()
    with torch.no_grad():
        for _ in range(n):
            lp = model(window[None].to(dev))[0, -1].cpu()
            if temperature <= 0:
                tok = int(lp.argmax())
            else:
                probs = torch.softmax(lp / temperature, dim=-1)
                tok = int(torch.multinomial(probs, 1, generator=generator))
            out.append(tok)
            window = torch.cat([window[1:], torch.tensor([tok])])
    model.train(was_training)
    return out


def run(steps: int = 200, seq_len: int = 32, batch: int = 16,
        vocab: int = 64, embed_dim: int = 128, depth: int = 2,
        num_heads: int = 4, mlp_ratio: int = 2, scale: bool = False,
        lr: float = 3e-3, seed: int = 0, attention: str = "xla",
        ring: bool = False, log_every: int = 25,
        corpus: Optional[str] = None, pp: int = 1, sample: int = 0,
        temperature: float = 0.8, export: Optional[str] = None,
        device="cuda", backend: Optional[str] = None) -> LMRun:
    """Train a ``BinarizedLM`` with ``max_len = seq_len`` for ``steps``
    steps on ``device`` (None: "cuda"; raises without a card, pass "cpu"
    to run there), then draw ``sample`` tokens (module docstring) and,
    with ``export``, freeze it to a packed artifact through
    ``infer.export_packed``. Products stay fp32 (TF32 off), as the
    reference computes. ``pp > 1``: the pipelined run, ``ring``: the
    sequence-parallel one (module docstring), their ranks over
    ``backend`` (None: NCCL on the cards, gloo on the CPU)."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if sample < 0:
        raise ValueError(f"sample must be >= 0, got {sample}")
    if export and (ring or pp > 1):
        raise ValueError("--export requires the plain model "
                         "(no --ring / --pp)")
    if ring and pp > 1:
        raise ValueError("--ring and --pp are mutually exclusive")
    kw = dict(steps=steps, seq_len=seq_len, batch=batch, vocab=vocab,
              embed_dim=embed_dim, depth=depth, num_heads=num_heads,
              mlp_ratio=mlp_ratio, scale=scale, lr=lr, seed=seed,
              attention=attention, log_every=log_every, corpus=corpus)
    if pp > 1:
        res = _run_pipelined(pp, kw, device, backend)
    elif ring:
        res = _run_ring(kw, device, backend)
    else:
        model, history = _train(resolve_device(device), **kw)
        res = LMRun(history, model, None)
    out = None
    if sample > 0:
        # the JAX package's window: the draw after its init batch and
        # one batch a step
        _, draw = token_stream(seq_len, batch, vocab, seed, corpus)
        for _ in range(steps + 2):
            window = draw()[0]
        out = sample_tokens(res.model, window, sample, temperature,
                            torch.Generator().manual_seed(seed + 2))
        if corpus is not None:
            text = bytes(out).decode("utf-8", errors="replace")
            print(f"sample ({sample} bytes, T={temperature}): {text!r}")
        else:
            print(f"sample ({sample} tokens, T={temperature}): {out}")
    info = None
    if export:
        info = export_packed(res.model.eval(), export)
        print(f"packed artifact -> {export}: {info['compression']}x over "
              f"the fp32 latents ({info['frozen_weight_bytes']} packed "
              "bytes)")
    return res._replace(export=info, sample=out)


def _train(dev: torch.device, *, steps, seq_len, batch, vocab, embed_dim,
           depth, num_heads, mlp_ratio, scale, lr, seed, attention,
           log_every, corpus, mesh=None, ring_group=None, log: bool = True):
    """The training loop on ``dev``: the model (with ``mesh``, this
    rank's ``PipelinedModel``; with ``ring_group``, the model whose
    attention is the ring over that group) and the logged losses."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vocab, draw = token_stream(seq_len, batch, vocab, seed, corpus)
    attention_fn = None
    if ring_group is not None:
        from ..parallel.ring_attention import make_ring_attention

        attention_fn = make_ring_attention(ring_group, causal=True)
    model = BinarizedLM(
        vocab=vocab, max_len=seq_len, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, mlp_ratio=mlp_ratio, scale=scale,
        attention=attention, attention_fn=attention_fn,
        generator=torch.Generator().manual_seed(seed),
    ).to(dev)
    if mesh is not None:
        from ..parallel import PipelinedModel

        model = PipelinedModel(model, mesh, n_micro=mesh.size("pipe"))
    latents = list(latent_clamp_mask(model).values())
    opt = make_optimizer(model, lr)
    history = []
    for i in range(steps):
        tokens = torch.from_numpy(draw()).to(dev)
        if mesh is not None:
            loss = _pp_step(model, opt, latents, tokens)
        elif ring_group is not None:
            loss = ring_train_step(model, opt, latents, tokens, ring_group)
        else:
            loss = train_step(model, opt, latents, tokens)
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


def _ring_rank(rank: int, world: int, device, kw: dict) -> dict:
    """One rank of ``run(ring=True)``: the training over the default
    group, the trained state (on the CPU) and this rank's kernel
    launches."""
    from ..ops import _kernels

    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    _kernels.reset_launches()
    model, history = _train(device, ring_group=dist.group.WORLD,
                            log=rank == 0, **kw)
    return {"history": history, "launches": dict(_kernels.LAUNCHES),
            "vocab": model.vocab,
            "state": {k: v.detach().cpu()
                      for k, v in model.state_dict().items()}}


def _run_ring(kw: dict, device, backend: Optional[str]) -> LMRun:
    from ..parallel import spawn

    dev = resolve_device(device)
    world = torch.cuda.device_count() if dev.type == "cuda" else 2
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if world < 1 or kw["seq_len"] % world:
        raise ValueError(f"--ring needs seq_len {kw['seq_len']} divisible "
                         f"by {world} ranks")
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise ValueError(f"--ring over {world} ranks needs {world} devices")
    ranks = spawn(_ring_rank, world, backend=backend, device=dev.type,
                  args=(kw,))
    model = BinarizedLM(
        vocab=ranks[0]["vocab"], max_len=kw["seq_len"],
        embed_dim=kw["embed_dim"], depth=kw["depth"],
        num_heads=kw["num_heads"], mlp_ratio=kw["mlp_ratio"],
        scale=kw["scale"], attention=kw["attention"])
    model.load_state_dict(ranks[0]["state"])
    return LMRun(ranks[0]["history"], model.to(dev), None, ranks)
