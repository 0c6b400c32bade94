"""Classification metrics, as the reference's ``accuracy`` (utils.py:
142-155) and the JAX package's ``utils/metrics.py``: precision@k for a
tuple of k values, in percent."""

from __future__ import annotations

from typing import List, Sequence

import torch


def accuracy(output: torch.Tensor, target: torch.Tensor,
             topk: Sequence[int] = (1,)) -> List[torch.Tensor]:
    """precision@k over a batch of logits or log-probs: one 0-d tensor in
    [0, 100] per k. The order is JAX's ``argsort(...)[:, ::-1]`` (of tied
    maxima the last ranks first)."""
    maxk = max(topk)
    order = torch.argsort(output, dim=-1, stable=True).flip(-1)[:, :maxk]
    correct = order == target[:, None]
    return [correct[:, :k].any(-1).to(torch.float32).mean() * 100.0
            for k in topk]
