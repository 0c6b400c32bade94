"""Optimizer registry + epoch-indexed "regime" scheduling.

Counterpart of the JAX package's ``train/optim.py`` (``OPTIMIZER_REGISTRY``,
``make_optimizer``, ``regime_hp_kwargs``, ``RegimeSchedule``). The JAX
package builds every optimizer from optax; ``torch.optim``'s classes of
the same names compute other updates (rmsprop's decay and eps placement,
adagrad's initial accumulator and eps, torch ASGD, gradient clipping's
``norm + 1e-6``), and lars and lamb have none. So each optimizer here is
a ``torch.optim.Optimizer`` whose update is written out from optax's
source (optax 0.2), transform by transform in optax's order:

  sgd       trace(momentum, nesterov) -> scale(-lr)
  asgd      sgd, plus the Polyak average of the iterates in state
  adam      scale_by_adam(b1, b2, eps, eps_root) -> scale(-lr)
  adamax    scale_by_adamax(b1, b2, eps) -> scale(-lr)
  adagrad   scale_by_rss(initial_accumulator_value, eps) -> scale(-lr)
  adadelta  add_decayed_weights -> scale_by_adadelta(rho, eps) -> scale(-lr)
  rprop     scale_by_rprop(lr, eta_minus, eta_plus, min/max step) -> scale(-1)
  rmsprop   scale_by_rms(decay, eps, initial_scale, eps_in_sqrt)
            -> scale(-lr) -> trace(momentum, nesterov)
  lars      add_decayed_weights -> scale_by_trust_ratio(trust_coefficient,
            eps) -> scale(-lr) -> trace(momentum, nesterov)
  lamb      scale_by_adam -> add_decayed_weights -> scale_by_trust_ratio
            -> scale(-lr)

then ``p += update``. With ``clip_grad_norm`` the gradients first go
through optax's ``clip_by_global_norm``: scaled by ``max_norm / norm``
only where ``norm >= max_norm``. A ``grad_transform`` (``sign_compress``,
the 1-bit data-parallel exchange) runs next, before the per-parameter
updates, as the JAX ``make_optimizer`` chains ``[clip, grad_transform,
base]``; its state (the error-feedback rows) rides in the optimizer's
``state_dict``. The per-parameter tensors are optax's leaves, so the
layerwise trust ratios of lars and lamb take the same norms.

Hyperparameters live in ``param_groups`` under optax's names
(``learning_rate``, ``momentum``, ``b1``, ...): a regime retunes them in
place and the next step reads them, with no reset of the moments, as
optax's ``inject_hyperparams`` does. A hyperparameter read only at
initialisation in optax (rprop's step sizes from the learning rate,
adagrad's and rmsprop's initial accumulators) is read at construction
here too. As the JAX ``make_optimizer`` materialises ``momentum=0.0``
where optax's default is None (sgd, rmsprop), the classes here default
to 0.0, so a regime can retune it. Hyperparameter arithmetic (``1 - b1``,
``b1 ** count``) is done in float32, as on optax's float32 hyperparams.

The step can be captured in a CUDA graph and replayed (the trainer's
``scan_steps`` and ``device_data``): every state tensor is written in
place (the last op of its expression writes it, ``out=``: the same
rounding, no extra copy), and the scalars that move from step to step (the learning rate,
Adam's, Adamax's and LAMB's bias corrections, ASGD's count) are read
from a small tensor on the parameters' device, one row a step, which
the host fills with the float32 arithmetic above (``scalar_rows``).
``step()`` makes that row itself and advances the host counters (the
per-parameter ``count`` and ``steps``); ``step(scalars=row)`` reads a
row the caller filled, and the caller advances the counters
(``advance``) once per dispatch. Both read the same device scalars:
PyTorch's CUDA true division multiplies by the reciprocal of a CPU
scalar but divides by a device tensor, which can round otherwise. The
other hyperparameters are constants of a captured step: a regime that
retunes one needs a new capture.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.comm_compress import (
    CommPlan,
    WireBytes,
    all_gather_compressed,
    all_reduce_mean,
    exchange,
    make_plan,
    pad_flat,
    reduce_scatter_compressed,
)

_HP_KEYS = ("learning_rate", "momentum", "b1", "b2", "eps", "weight_decay")


def _f32(x: float) -> float:
    """x rounded to float32, as a Python float (exact in float32)."""
    return float(np.float32(x))


def _one_minus(x: float) -> float:
    """``1 - x`` in float32, as optax computes it on a float32 hyperparam."""
    return float(np.float32(1.0) - np.float32(x))


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count`` in float32."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sq: Optional[List[torch.Tensor]] = None
                        ) -> List[torch.Tensor]:
    """optax ``clip_by_global_norm``: every tensor scaled by
    ``max_norm / norm`` when the global norm is >= max_norm, unchanged
    otherwise. No host sync: the choice is a ``torch.where``. ``sq``:
    each leaf's sum of squares when the tensors are shards of the leaves
    (``parallel.fsdp.FsdpShards.sq_norms``)."""
    if not grads:
        return grads
    if sq is None:
        sq = [torch.sum(g * g) for g in grads]
    norm = torch.sqrt(sum(sq))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def _trace(u: torch.Tensor, state: Dict[str, Any], momentum: float,
           nesterov: bool) -> torch.Tensor:
    """optax ``trace``: t = u + momentum * t; u + momentum * t under
    nesterov, else t."""
    t = torch.add(u, _f32(momentum) * state["trace"], out=state["trace"])
    return u + _f32(momentum) * t if nesterov else t


def _trust_ratio(u: torch.Tensor, p: torch.Tensor, trust_coefficient: float,
                 eps: float, norms=None) -> torch.Tensor:
    """optax ``scale_by_trust_ratio`` (min_norm 0): u * tc * |p| / (|u| +
    eps), or u where either norm is 0. ``norms``: ``(|p|, |u|)`` of the
    whole leaves when ``p`` and ``u`` are shards of them."""
    if norms is None:
        p_norm = torch.linalg.vector_norm(p)
        u_norm = torch.linalg.vector_norm(u)
    else:
        p_norm, u_norm = norms
    ratio = _f32(trust_coefficient) * p_norm / (u_norm + _f32(eps))
    zero = (p_norm == 0.0) | (u_norm == 0.0)
    return u * torch.where(zero, torch.ones_like(ratio), ratio)


def _adam_direction(g: torch.Tensor, state: Dict[str, Any],
                    group: Dict[str, Any],
                    sc: Dict[str, torch.Tensor]) -> torch.Tensor:
    """optax ``scale_by_adam`` (no nesterov): bias-corrected mu / (sqrt(nu
    + eps_root) + eps), the corrections ``sc["bc1"]``, ``sc["bc2"]``."""
    b1, b2 = group["b1"], group["b2"]
    torch.add(_one_minus(b1) * g, _f32(b1) * state["mu"], out=state["mu"])
    torch.add(_one_minus(b2) * (g * g), _f32(b2) * state["nu"],
              out=state["nu"])
    mu_hat = state["mu"] / sc["bc1"]
    nu_hat = state["nu"] / sc["bc2"]
    return mu_hat / (torch.sqrt(nu_hat + _f32(group["eps_root"]))
                     + _f32(group["eps"]))


def _adam_row(group: Dict[str, Any], count: int) -> List[float]:
    """``scale_by_adam``'s bias corrections of step ``count``."""
    return [_bias_correction(group["b1"], count),
            _bias_correction(group["b2"], count)]


class OptaxOptimizer(torch.optim.Optimizer):
    """Base: ``step()`` clips the gradients by global norm (if set), runs
    ``grad_transform`` on them (if set), asks ``_update`` for each
    parameter's optax update and adds it. State is made at construction,
    as ``tx.init(params)`` makes it; ``steps`` counts the updates, as
    ``inject_hyperparams``' ``count`` does.

    ``SCALARS`` names the columns of a group's slice of a step's scalar
    row (``neg_lr`` = -learning_rate, then the class's own), which
    ``_row`` computes for the step whose count is ``count``."""

    SCALARS: Tuple[str, ...] = ("neg_lr",)

    def __init__(self, params: Iterable, defaults: Dict[str, Any],
                 clip_grad_norm: Optional[float] = None):
        super().__init__(params, defaults)
        if clip_grad_norm is not None and clip_grad_norm <= 0:
            raise ValueError(
                f"clip_grad_norm must be > 0, got {clip_grad_norm}")
        self.clip_grad_norm = clip_grad_norm
        self.grad_transform: Optional[SignCompress] = None
        # the 1-bit FSDP exchange that runs this optimizer on a segment
        self.fsdp_compress: Optional[SignCompressFsdp] = None
        # fp32 FSDP: the shards' whole-leaf norms (parallel.fsdp)
        self.fsdp = None
        # tensor parallelism: the model's own parameters are shards
        # (parallel.model_parallel.TpShards): whole-leaf norms too
        self.tp = None
        # tensors whose gradients the step reads, where they are not the
        # optimizer's own parameters (the full parameters of a sharded
        # or segment optimizer); zero_grad clears them too
        self.grad_params: List[torch.Tensor] = []
        self.steps = 0
        for group in self.param_groups:
            for p in group["params"]:
                self._init_state(p, self.state[p], group)

    def _init_state(self, p: torch.Tensor, state: Dict[str, Any],
                    group: Dict[str, Any]) -> None:
        raise NotImplementedError

    def _update(self, p: torch.Tensor, g: torch.Tensor,
                state: Dict[str, Any], group: Dict[str, Any],
                sc: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def _row(self, group: Dict[str, Any], count: int) -> List[float]:
        return [-_f32(group["learning_rate"])]

    def _count(self, group: Dict[str, Any]) -> int:
        """The optax count of the group's state before the next step
        (``steps`` for a class that keeps none)."""
        state = self.state[group["params"][0]] if group["params"] else {}
        return state.get("count", self.steps)

    def scalar_rows(self, n: int) -> np.ndarray:
        """(n, width) float32: the scalars of the next ``n`` steps, one
        row a step, every group's ``SCALARS`` in turn."""
        rows = np.empty((n, len(self.SCALARS) * len(self.param_groups)),
                        np.float32)
        for i in range(n):
            rows[i] = [v for group in self.param_groups
                       for v in self._row(group, self._count(group) + i + 1)]
        return rows

    def advance(self, n: int) -> None:
        """Move the host counters ``n`` steps on: ``steps`` and every
        state's ``count``, as ``n`` calls of ``step()`` would."""
        self.steps += n
        for state in self.state.values():
            if "count" in state:
                state["count"] += n

    def _device_row(self) -> torch.Tensor:
        row = torch.from_numpy(self.scalar_rows(1)[0])
        device = self.param_groups[0]["params"][0].device
        if device.type == "cuda":
            return row.pin_memory().to(device, non_blocking=True)
        return row

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None,
             scalars: Optional[torch.Tensor] = None):
        """One update. ``scalars``: this step's row of ``scalar_rows`` on
        the parameters' device (the counters are then the caller's to
        advance); None makes the row and advances them."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        own = scalars is None
        if own:
            scalars = self._device_row()
        width = len(self.SCALARS)
        group_sc = {}
        for i, group in enumerate(self.param_groups):
            group_sc[id(group)] = {
                name: scalars[i * width + j]
                for j, name in enumerate(self.SCALARS)}
        if self.fsdp_compress is not None:
            self._step_fsdp_compress(group_sc)
        else:
            pairs = [(p, group) for group in self.param_groups
                     for p in group["params"] if p.grad is not None]
            grads = [p.grad for p, _ in pairs]
            if self.clip_grad_norm is not None:
                shards = self.fsdp or self.tp
                sq = None if shards is None else shards.sq_norms(
                    [(p, g) for (p, _), g in zip(pairs, grads)])
                grads = clip_by_global_norm(grads, self.clip_grad_norm, sq)
            if self.grad_transform is not None:
                grads = self.grad_transform([p for p, _ in pairs], grads)
            for (p, group), g in zip(pairs, grads):
                p.add_(self._update(p, g, self.state[p], group,
                                    group_sc[id(group)]))
        if own:
            self.advance(1)
        return loss

    def _step_fsdp_compress(self, group_sc) -> None:
        """The JAX chain ``[clip, sign_compress_fsdp(base)]``: the local
        gradients of ``grad_params`` clipped, then the exchange, which
        runs this optimizer's ``_update`` on its segment; every full
        parameter takes the decoded update."""
        params = [p for p in self.grad_params if p.grad is not None]
        grads = [p.grad for p in params]
        if self.clip_grad_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_grad_norm)
        group = self.param_groups[0]
        seg = group["params"][0]

        def base(own: torch.Tensor) -> torch.Tensor:
            return self._update(seg, own, self.state[seg], group,
                                group_sc[id(group)])

        for p, u in zip(params, self.fsdp_compress(params, grads, base)):
            p.add_(u)

    def _leaf_norms(self, p: torch.Tensor, u: torch.Tensor):
        """``(|p|, |u|)`` of the whole leaf of which ``p`` is a shard
        (fp32 FSDP, tensor parallelism), or None where ``p`` is the
        leaf."""
        shards = self.fsdp or self.tp
        if shards is None:
            return None
        sq = shards.sq_norms([(p, p), (p, u)])
        return torch.sqrt(sq[0]), torch.sqrt(sq[1])

    def zero_grad(self, set_to_none: bool = True) -> None:
        super().zero_grad(set_to_none=set_to_none)
        for p in self.grad_params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step writes that the optimizer holds: its
        parameters (shards or a segment where they are not the model's),
        their state and the exchange's rows."""
        out = [p for group in self.param_groups for p in group["params"]]
        for state in self.state.values():
            out.extend(v for v in state.values() if torch.is_tensor(v))
        for tx in (self.grad_transform, self.fsdp_compress):
            if tx is not None:
                out.extend(tx.tensors())
        return list({id(t): t for t in out}.values())

    def comm_transform(self):
        """The 1-bit exchange this optimizer runs (``SignCompress`` in
        front of it, or ``SignCompressFsdp`` around it), if any."""
        return self.grad_transform or self.fsdp_compress

    def state_dict(self) -> Dict[str, Any]:
        sd = super().state_dict()
        if self.comm_transform() is not None:
            sd["grad_transform"] = self.comm_transform().state_dict()
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        state_dict = dict(state_dict)
        transform = state_dict.pop("grad_transform", None)
        super().load_state_dict(state_dict)
        if self.comm_transform() is not None and transform is not None:
            self.comm_transform().load_state_dict(transform)


class SGD(OptaxOptimizer):
    def __init__(self, params, learning_rate: float, momentum: float = 0.0,
                 nesterov: bool = False, clip_grad_norm=None):
        super().__init__(params, dict(learning_rate=learning_rate,
                                      momentum=momentum, nesterov=nesterov),
                         clip_grad_norm)

    def _init_state(self, p, state, group):
        state["trace"] = torch.zeros_like(p)

    def _update(self, p, g, state, group, sc):
        u = _trace(g, state, group["momentum"], group["nesterov"])
        return u * sc["neg_lr"]


class ASGD(OptaxOptimizer):
    """SGD with the Polyak average of the iterates in state (``avg``),
    the JAX package's ``_asgd``; it steps as plain SGD."""

    SCALARS = ("neg_lr", "count")

    def __init__(self, params, learning_rate: float = 0.01,
                 clip_grad_norm=None):
        super().__init__(params, dict(learning_rate=learning_rate),
                         clip_grad_norm)

    def _init_state(self, p, state, group):
        state["avg"] = p.detach().clone()
        state["count"] = 0

    def _row(self, group, count):
        return super()._row(group, count) + [float(count)]

    def _update(self, p, g, state, group, sc):
        u = g * sc["neg_lr"]
        torch.add(state["avg"], ((p + u) - state["avg"]) / sc["count"],
                  out=state["avg"])
        return u


class Adam(OptaxOptimizer):
    SCALARS = ("neg_lr", "bc1", "bc2")

    def __init__(self, params, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 clip_grad_norm=None):
        super().__init__(params, dict(learning_rate=learning_rate, b1=b1,
                                      b2=b2, eps=eps, eps_root=eps_root),
                         clip_grad_norm)

    def _init_state(self, p, state, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)
        state["count"] = 0

    def _row(self, group, count):
        return super()._row(group, count) + _adam_row(group, count)

    def _update(self, p, g, state, group, sc):
        return _adam_direction(g, state, group, sc) * sc["neg_lr"]


class Adamax(OptaxOptimizer):
    SCALARS = ("neg_lr", "bc1")

    def __init__(self, params, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, clip_grad_norm=None):
        super().__init__(params, dict(learning_rate=learning_rate, b1=b1,
                                      b2=b2, eps=eps), clip_grad_norm)

    def _init_state(self, p, state, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)
        state["count"] = 0

    def _row(self, group, count):
        return super()._row(group, count) + [
            _bias_correction(group["b1"], count)]

    def _update(self, p, g, state, group, sc):
        b1 = group["b1"]
        torch.add(_one_minus(b1) * g, _f32(b1) * state["mu"],
                  out=state["mu"])
        torch.maximum(g.abs() + _f32(group["eps"]),
                      _f32(group["b2"]) * state["nu"], out=state["nu"])
        mu_hat = state["mu"] / sc["bc1"]
        return (mu_hat / state["nu"]) * sc["neg_lr"]


class Adagrad(OptaxOptimizer):
    def __init__(self, params, learning_rate: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7,
                 clip_grad_norm=None):
        super().__init__(params, dict(
            learning_rate=learning_rate,
            initial_accumulator_value=initial_accumulator_value, eps=eps),
            clip_grad_norm)

    def _init_state(self, p, state, group):
        state["sum_of_squares"] = torch.full_like(
            p, _f32(group["initial_accumulator_value"]))

    def _update(self, p, g, state, group, sc):
        s = torch.add(g * g, state["sum_of_squares"],
                      out=state["sum_of_squares"])
        inv = torch.where(s > 0, torch.rsqrt(s + _f32(group["eps"])),
                          torch.zeros_like(s))
        return (inv * g) * sc["neg_lr"]


class Adadelta(OptaxOptimizer):
    def __init__(self, params, learning_rate: float, rho: float = 0.9,
                 eps: float = 1e-6, weight_decay: float = 0.0,
                 clip_grad_norm=None):
        super().__init__(params, dict(learning_rate=learning_rate, rho=rho,
                                      eps=eps, weight_decay=weight_decay),
                         clip_grad_norm)

    def _init_state(self, p, state, group):
        state["e_g"] = torch.zeros_like(p)
        state["e_x"] = torch.zeros_like(p)

    def _update(self, p, g, state, group, sc):
        rho, eps = group["rho"], _f32(group["eps"])
        u = g + _f32(group["weight_decay"]) * p
        torch.add(_one_minus(rho) * (u * u), _f32(rho) * state["e_g"],
                  out=state["e_g"])
        u = (torch.sqrt(state["e_x"] + eps)
             / torch.sqrt(state["e_g"] + eps)) * u
        torch.add(_one_minus(rho) * (u * u), _f32(rho) * state["e_x"],
                  out=state["e_x"])
        return u * sc["neg_lr"]


class Rprop(OptaxOptimizer):
    """optax ``rprop``. As optax 0.2 writes it, the update a step applies
    is the previous step's stored ``step_size * sign(g)`` (zero where the
    gradient's sign flipped), so the first step applies zero."""

    def __init__(self, params, learning_rate: float, eta_minus: float = 0.5,
                 eta_plus: float = 1.2, min_step_size: float = 1e-6,
                 max_step_size: float = 50.0, clip_grad_norm=None):
        super().__init__(params, dict(
            learning_rate=learning_rate, eta_minus=eta_minus,
            eta_plus=eta_plus, min_step_size=min_step_size,
            max_step_size=max_step_size), clip_grad_norm)

    def _init_state(self, p, state, group):
        state["step_sizes"] = torch.full_like(p, _f32(group["learning_rate"]))
        state["prev_updates"] = torch.zeros_like(p)

    def _update(self, p, g, state, group, sc):
        s = g * state["prev_updates"]
        step = state["step_sizes"]
        factor = torch.where(s > 0, _f32(group["eta_plus"]),
                             _f32(group["eta_minus"]))
        step = torch.where(
            s == 0, step,
            torch.clamp(step * factor, min=_f32(group["min_step_size"]),
                        max=_f32(group["max_step_size"])))
        zeros = torch.zeros_like(g)
        new_prev = torch.where(s < 0, zeros, step * torch.sign(g))
        u = torch.where(s < 0, zeros, state["prev_updates"])
        state["step_sizes"].copy_(step)
        state["prev_updates"].copy_(new_prev)
        return u * -1.0


class RMSprop(OptaxOptimizer):
    """optax ``rmsprop`` (not centered, no bias correction)."""

    def __init__(self, params, learning_rate: float, decay: float = 0.9,
                 eps: float = 1e-8, initial_scale: float = 0.0,
                 eps_in_sqrt: bool = True, momentum: float = 0.0,
                 nesterov: bool = False, clip_grad_norm=None):
        super().__init__(params, dict(
            learning_rate=learning_rate, decay=decay, eps=eps,
            initial_scale=initial_scale, eps_in_sqrt=eps_in_sqrt,
            momentum=momentum, nesterov=nesterov), clip_grad_norm)

    def _init_state(self, p, state, group):
        state["nu"] = torch.full_like(p, _f32(group["initial_scale"]))
        state["trace"] = torch.zeros_like(p)

    def _update(self, p, g, state, group, sc):
        decay, eps = group["decay"], _f32(group["eps"])
        nu = torch.add(_one_minus(decay) * (g * g), _f32(decay) * state["nu"],
                       out=state["nu"])
        if group["eps_in_sqrt"]:
            scaling = torch.rsqrt(nu + eps)
        else:
            scaling = 1.0 / (torch.sqrt(nu) + eps)
        u = (scaling * g) * sc["neg_lr"]
        return _trace(u, state, group["momentum"], group["nesterov"])


class LARS(OptaxOptimizer):
    """optax ``lars`` with its default masks (weight decay and trust
    ratio on every parameter)."""

    def __init__(self, params, learning_rate: float,
                 weight_decay: float = 0.0, trust_coefficient: float = 0.001,
                 eps: float = 0.0, momentum: float = 0.9,
                 nesterov: bool = False, clip_grad_norm=None):
        super().__init__(params, dict(
            learning_rate=learning_rate, weight_decay=weight_decay,
            trust_coefficient=trust_coefficient, eps=eps, momentum=momentum,
            nesterov=nesterov), clip_grad_norm)

    def _init_state(self, p, state, group):
        state["trace"] = torch.zeros_like(p)

    def _update(self, p, g, state, group, sc):
        u = g + _f32(group["weight_decay"]) * p
        u = _trust_ratio(u, p, group["trust_coefficient"], group["eps"],
                         self._leaf_norms(p, u))
        u = u * sc["neg_lr"]
        return _trace(u, state, group["momentum"], group["nesterov"])


class LAMB(OptaxOptimizer):
    """optax ``lamb`` (weight decay on every parameter)."""

    SCALARS = ("neg_lr", "bc1", "bc2")

    def __init__(self, params, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6, eps_root: float = 0.0,
                 weight_decay: float = 0.0, clip_grad_norm=None):
        super().__init__(params, dict(
            learning_rate=learning_rate, b1=b1, b2=b2, eps=eps,
            eps_root=eps_root, weight_decay=weight_decay), clip_grad_norm)

    def _init_state(self, p, state, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)
        state["count"] = 0

    def _row(self, group, count):
        return super()._row(group, count) + _adam_row(group, count)

    def _update(self, p, g, state, group, sc):
        u = _adam_direction(g, state, group, sc)
        u = u + _f32(group["weight_decay"]) * p
        u = _trust_ratio(u, p, 1.0, 0.0, self._leaf_norms(p, u))
        return u * sc["neg_lr"]


OPTIMIZER_REGISTRY: Dict[str, type] = {
    "sgd": SGD,
    "asgd": ASGD,
    "adam": Adam,
    "adamax": Adamax,
    "adagrad": Adagrad,
    "adadelta": Adadelta,
    "rprop": Rprop,
    "rmsprop": RMSprop,
    "lars": LARS,
    "lamb": LAMB,
}


def _optimizer_class(name: str) -> type:
    try:
        return OPTIMIZER_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown optimizer {name!r}; available: "
            f"{sorted(OPTIMIZER_REGISTRY)}"
        ) from None


def check_elementwise(name: str) -> None:
    """Raise for a layerwise optimizer, which the compressed FSDP
    exchange cannot run (the JAX Trainer's rule and message)."""
    if name.lower() in ("lars", "lamb"):
        raise ValueError(
            f"optimizer {name!r} does not compose with grad_compress "
            "under dp_mode='fsdp': the compressed-FSDP exchange runs "
            "the optimizer on flattened ZeRO segments, where layerwise "
            "trust ratios would silently compute norms over arbitrary "
            "slices (use an elementwise optimizer, or dp_mode='gspmd')")


def make_optimizer(name: str, params: Iterable, learning_rate: float, *,
                   clip_grad_norm: Optional[float] = None,
                   grad_transform: Optional["SignCompress"] = None,
                   fsdp_compress: Optional["SignCompressFsdp"] = None,
                   fsdp=None, tp=None, **kwargs: Any) -> OptaxOptimizer:
    """The registry optimizer ``name`` over ``params`` (torch optimizers
    take their parameters at construction; the JAX ``make_optimizer``
    returns a transform that ``init`` gives them), with ``learning_rate``
    and any other hyperparameter in ``param_groups``, optionally behind
    global-norm clipping and then ``grad_transform``.

    ``fsdp_compress`` (the JAX ``grad_transform_wrapper`` of
    ``sign_compress_fsdp``) wraps the optimizer instead: it runs on the
    exchange's flat segment (its state the segment's moment rows) and
    ``params`` are the full parameters whose gradients it reads. Only
    elementwise optimizers compose with it. ``fsdp`` (fp32 FSDP, a
    ``parallel.fsdp.FsdpShards`` of ``params``) runs it on this rank's
    shards, its norms over whole leaves. ``tp`` (a
    ``parallel.model_parallel.TpShards``: ``params`` are a tensor-parallel
    model's shards) gives it whole-leaf norms over the model group."""
    if grad_transform is not None and fsdp_compress is not None:
        raise ValueError("grad_transform and fsdp_compress are mutually "
                         "exclusive (chain-in-front vs wrap-the-optimizer)")
    grad_params: List[torch.Tensor] = []
    if fsdp_compress is not None:
        check_elementwise(name)
        grad_params, params = list(params), [fsdp_compress.segment]
    elif fsdp is not None:
        grad_params, params = list(params), fsdp.tensors
    opt = _optimizer_class(name)(params, learning_rate=learning_rate,
                                 clip_grad_norm=clip_grad_norm, **kwargs)
    opt.grad_transform = grad_transform
    opt.fsdp_compress = fsdp_compress
    opt.fsdp = fsdp
    opt.tp = tp
    opt.grad_params = grad_params
    return opt


def _hyperparams(name: str) -> set:
    import inspect

    sig = inspect.signature(_optimizer_class(name).__init__)
    return set(sig.parameters) - {"self", "params", "clip_grad_norm"}


def regime_hp_kwargs(name: str, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The hyperparameters of a regime config that optimizer ``name``
    takes (the learning rate excepted); others are ignored, as torch
    ignores unknown param-group keys."""
    accepted = _hyperparams(name)
    return {k: cfg[k] for k in _HP_KEYS
            if k != "learning_rate" and k in cfg and k in accepted}


class RegimeSchedule:
    """Epoch-indexed optimizer regime with sticky replay: ``regime`` is
    {epoch: {"optimizer": name, "learning_rate": f, ...}} or a callable
    epoch -> dict, and ``config_at(epoch)`` merges entries 0..epoch."""

    def __init__(self, regime):
        self.regime = regime

    def config_at(self, epoch: int) -> Dict[str, Any]:
        if self.regime is None:
            return {}
        merged: Dict[str, Any] = {}
        if callable(self.regime):
            for e in range(epoch + 1):
                merged.update(self.regime(e) or {})
            return merged
        for e in sorted(self.regime):
            if e <= epoch:
                merged.update(self.regime[e])
        return merged

    def optimizer_changed(self, epoch: int) -> bool:
        """Did the optimizer *class* change exactly at this epoch?"""
        if epoch == 0:
            return False
        prev = self.config_at(epoch - 1).get("optimizer")
        now = self.config_at(epoch).get("optimizer")
        return now is not None and now != prev

    def apply_hyperparams(self, optimizer: torch.optim.Optimizer,
                          epoch: int) -> None:
        """Write the regime's hyperparameters for this epoch into every
        param group that has them (no moment reset)."""
        cfg = self.config_at(epoch)
        for group in optimizer.param_groups:
            for k in _HP_KEYS:
                if k in cfg and k in group:
                    group[k] = cfg[k]


class SignCompress:
    """The 1-bit gradient exchange as a gradient transform (the JAX
    ``sign_compress`` with its ``SignCompressState``), run by
    ``OptaxOptimizer.step`` after clipping and before the updates.

    ``transform(params, grads)`` lays the (local, per-worker) gradients
    end to end in the JAX flat order (``order``, an
    ``interop.JaxFlatOrder``), pads them to the plan, adds this worker's
    residual (``sign_ef``), runs ``ops.comm_compress.exchange`` over
    ``group`` (this is the data-parallel reduction: the step that hosts
    it reduces no gradient itself), slices off the pad and returns the
    combined update cut back into tensors shaped like ``params``.
    ``mode="sign"`` is the stateless majority vote.

    ``sign_ef`` keeps this worker's rows of the error feedback, row
    ``rank`` of JAX's ``(world, padded)`` ``ef_residual`` and ``(world,
    seg)`` ``ef_residual2``, zeroed where JAX zeroes them (the pad tail
    of the first, the invalid tail of the last worker's segment of the
    second); ``state_dict`` carries them.

    Hierarchical form: with ``local_group`` the gradient is first
    fp32-averaged over it (the in-host all-reduce) and the exchange runs
    over ``group``, the inter-host group, with ``world`` the number of
    hosts. ``world > 1`` needs a ``group``; ``world=1`` runs no
    collective. Collectives add their bytes to ``wire``."""

    def __init__(self, *, mode: str, order, world: int = 1, group=None,
                 local_group=None, bucket_size: int = 1024, chunks: int = 4,
                 wire: Optional[WireBytes] = None):
        if mode not in ("sign", "sign_ef"):
            raise ValueError(
                f"unknown compression mode {mode!r} (have: sign, sign_ef)")
        if group is None and world != 1:
            raise ValueError("world > 1 requires a group to exchange over")
        if local_group is not None and group is None:
            raise ValueError("local_group (hierarchical exchange) requires "
                             "group for the inter-host phase")
        self.mode = mode
        self.order = order
        self.group = group
        self.local_group = local_group
        self.wire = WireBytes() if wire is None else wire
        self.plan: CommPlan = make_plan(order.n_params, world=world,
                                        mode=mode, bucket_size=bucket_size,
                                        chunks=chunks)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.ef_residual: Optional[torch.Tensor] = None
        self.ef_residual2: Optional[torch.Tensor] = None
        if mode == "sign_ef":
            device = order.entries[0][1].device
            self.ef_residual = torch.zeros(self.plan.padded, device=device)
            self.ef_residual2 = torch.zeros(self.plan.seg, device=device)

    def __call__(self, params: List[torch.Tensor],
                 grads: List[torch.Tensor]) -> List[torch.Tensor]:
        plan = self.plan
        flat = self.order.flatten(dict(zip(params, grads)))
        if self.local_group is not None:
            flat = all_reduce_mean(flat, self.local_group, self.wire,
                                   level="intra")
        flat = pad_flat(flat, plan)
        if self.mode == "sign_ef":
            corrected = flat + self.ef_residual
            e2 = self.ef_residual2
        else:
            corrected, e2 = flat, None
        combined, sent, e2_new = exchange(corrected, plan, group=self.group,
                                          e2=e2, wire=self.wire)
        if self.mode == "sign_ef":
            _keep_residuals(self, plan, corrected - sent, e2_new)
        update = self.order.unflatten(combined[:plan.n_params])
        return [update[p] for p in params]

    def tensors(self) -> List[torch.Tensor]:
        """The rows a step writes (in place: a captured step keeps
        them)."""
        return [t for t in (self.ef_residual, self.ef_residual2)
                if t is not None]

    def state_dict(self) -> Dict[str, Any]:
        if self.mode != "sign_ef":
            return {}
        return {"ef_residual": self.ef_residual.clone(),
                "ef_residual2": self.ef_residual2.clone()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if self.mode != "sign_ef":
            return
        for k in ("ef_residual", "ef_residual2"):
            cur = getattr(self, k)
            if tuple(state[k].shape) != tuple(cur.shape):
                raise ValueError(f"{k} of shape {tuple(state[k].shape)}, "
                                 f"want {tuple(cur.shape)}")
            cur.copy_(state[k])


def _keep_residuals(tx, plan: CommPlan, e1: torch.Tensor,
                    e2: torch.Tensor) -> None:
    """Write the new error feedback into ``tx``'s rows, in place: ``e1``
    with its pad tail zeroed, ``e2`` zeroed past ``n_params`` (the
    invalid tail of the last worker's segment), as JAX zeroes them."""
    e1[plan.n_params:] = 0.0
    seg0 = tx.rank * plan.seg
    valid2 = seg0 + torch.arange(plan.seg, device=e1.device)
    tx.ef_residual.copy_(e1)
    tx.ef_residual2.copy_(torch.where(valid2 < plan.n_params, e2,
                                      torch.zeros_like(e2)))


sign_compress = SignCompress   # the JAX package's name


class SignCompressFsdp:
    """The 1-bit compressed FSDP exchange (the JAX ``sign_compress_fsdp``
    with its ``FsdpCompressState``): the ZeRO layout of the 1-bit
    exchange, which wraps the base optimizer
    (``make_optimizer(..., fsdp_compress=...)``) instead of running in
    front of it.

    ``transform(params, grads, base)``, per step:

    1. this worker's gradients in the JAX flat order, padded, plus its
       residual (``sign_ef``), go through the compressed reduce-scatter
       (``ops.comm_compress.reduce_scatter_compressed``): sign planes and
       bucket scales to the segment owners, each owner combining its
       ``(seg,)`` segment;
    2. ``base(own)``, the base optimizer's update of the owner's segment
       (``segment``: this worker's ``(seg,)`` slice of the padded flat
       parameters, refreshed first; the optimizer's state is that
       segment's moment rows, row ``rank`` of JAX's ``(world, seg)``);
    3. the update (plus the owner's residual under ``sign_ef``) goes
       through the compressed all-gather
       (``all_gather_compressed``), and every worker applies the same
       decoded update, so the parameters stay equal on every rank.

    ``sign_ef`` keeps two residuals, this worker's ``(padded,)`` row and
    the owner's ``(seg,)`` row, written in place (a captured step keeps
    them); ``sign`` keeps none (JAX's ``(world, 0)`` rows). ``world=1``
    runs no collective. Collectives add their bytes to ``wire``."""

    def __init__(self, *, mode: str, order, world: int = 1, group=None,
                 bucket_size: int = 1024, chunks: int = 4,
                 wire: Optional[WireBytes] = None):
        if mode not in ("sign", "sign_ef"):
            raise ValueError(
                f"unknown compression mode {mode!r} (have: sign, sign_ef)")
        if group is None and world != 1:
            raise ValueError("world > 1 requires a group to exchange over")
        self.mode = mode
        self.order = order
        self.group = group
        self.wire = WireBytes() if wire is None else wire
        self.plan: CommPlan = make_plan(order.n_params, world=world,
                                        mode=mode, bucket_size=bucket_size,
                                        chunks=chunks, layout="fsdp")
        self.rank = 0 if group is None else dist.get_rank(group)
        device = order.entries[0][1].device
        self.segment = torch.empty(self.plan.seg, device=device)
        self.refresh_segment()
        self.ef_residual: Optional[torch.Tensor] = None
        self.ef_residual2: Optional[torch.Tensor] = None
        if mode == "sign_ef":
            self.ef_residual = torch.zeros(self.plan.padded, device=device)
            self.ef_residual2 = torch.zeros(self.plan.seg, device=device)

    @torch.no_grad()
    def refresh_segment(self) -> None:
        """``segment`` := this worker's slice of the padded flat
        parameters."""
        plan = self.plan
        flat = pad_flat(self.order.flatten(), plan)
        self.segment.copy_(flat[self.rank * plan.seg:
                                (self.rank + 1) * plan.seg])

    def __call__(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                 base: Callable[[torch.Tensor], torch.Tensor]
                 ) -> List[torch.Tensor]:
        plan = self.plan
        flat = pad_flat(self.order.flatten(dict(zip(params, grads))), plan)
        corrected = (flat + self.ef_residual if self.mode == "sign_ef"
                     else flat)
        own, sent = reduce_scatter_compressed(corrected, plan,
                                              group=self.group,
                                              wire=self.wire)
        self.refresh_segment()
        delta = base(own)
        if self.mode == "sign_ef":
            delta = delta + self.ef_residual2
        full, own_dec = all_gather_compressed(delta, plan, group=self.group,
                                              wire=self.wire)
        if self.mode == "sign_ef":
            _keep_residuals(self, plan, corrected - sent, delta - own_dec)
        update = self.order.unflatten(full[:plan.n_params])
        return [update[p] for p in params]

    def tensors(self) -> List[torch.Tensor]:
        """The rows a step writes, in place."""
        return [t for t in (self.segment, self.ef_residual,
                            self.ef_residual2) if t is not None]

    def state_dict(self) -> Dict[str, Any]:
        if self.mode != "sign_ef":
            return {}
        return {"ef_residual": self.ef_residual.clone(),
                "ef_residual2": self.ef_residual2.clone()}

    load_state_dict = SignCompress.load_state_dict


sign_compress_fsdp = SignCompressFsdp   # the JAX package's name
