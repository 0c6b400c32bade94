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

Not here yet: sequence-parallel ring attention (``ring``, ROADMAP item 12)
and the model-level pipeline (``pp``, ROADMAP item 14) raise; sampling
after training goes through ``cli lm --load PATH --sample N`` on the
exported artifact.
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
    model: BinarizedLM       # the trained model, on the run's device
    export: Optional[dict]   # export_packed's info, when exported


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
        export: Optional[str] = None, device="cuda") -> LMRun:
    """Train a ``BinarizedLM`` with ``max_len = seq_len`` for ``steps``
    steps on ``device`` (None: "cuda"; raises without a card, pass "cpu"
    to run there) and, with ``export``, freeze it to a packed artifact
    through ``infer.export_packed``. Products stay fp32 (TF32 off), as
    the reference computes."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if ring:
        raise NotImplementedError(
            "ring attention is not ported yet (ROADMAP item 12, "
            "parallel/ring_attention.py)"
        )
    if pp > 1:
        raise NotImplementedError(
            "the model-level pipeline is not ported yet (ROADMAP item 14, "
            "parallel/pipeline_model.py)"
        )
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vocab, draw = token_stream(seq_len, batch, vocab, seed, corpus)
    model = BinarizedLM(
        vocab=vocab, max_len=seq_len, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, mlp_ratio=mlp_ratio, scale=scale,
        attention=attention, generator=torch.Generator().manual_seed(seed),
    ).to(dev)
    latents = list(latent_clamp_mask(model).values())
    opt = make_optimizer(model, lr)
    history = []
    for i in range(steps):
        loss = train_step(model, opt, latents,
                          torch.from_numpy(draw()).to(dev))
        if i % log_every == 0 or i == steps - 1:
            loss = float(loss)
            history.append(loss)
            print(f"step {i:4d}  next-token loss {loss:.4f} "
                  f"({loss / float(np.log(2.0)):.3f} bits/token)")
    info = None
    if export:
        info = export_packed(model.eval(), export)
        print(f"packed artifact -> {export}: {info['compression']}x over "
              f"the fp32 latents ({info['frozen_weight_bytes']} packed "
              "bytes)")
    return LMRun(history, model, info)
