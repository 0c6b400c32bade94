"""Logging set-up, as the reference's ``setup_logging`` (utils.py:16-28)
and the JAX package's ``utils/logging_utils.py``: DEBUG to a fresh file,
INFO to the console, and output from the primary rank only
(mnist-dist2.py:141-149)."""

from __future__ import annotations

import logging
import os

import torch.distributed as dist


def is_primary_host() -> bool:
    """True in the process that logs and writes checkpoints: rank 0 of
    the ``torch.distributed`` process group, or the only process when
    there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def setup_logging(log_file: str = "log.txt", *, level: int = logging.DEBUG,
                  console_level: int = logging.INFO,
                  primary_only: bool = True) -> logging.Logger:
    """The root logger: ``level`` to ``log_file`` (truncated), and
    ``console_level`` to the console. With ``primary_only`` the other
    ranks log WARNING and above to the console and write no file."""
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    root.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s",
                            "%Y-%m-%d %H:%M:%S")
    primary = is_primary_host() or not primary_only
    console = logging.StreamHandler()
    console.setLevel(console_level if primary else logging.WARNING)
    console.setFormatter(fmt)
    root.addHandler(console)
    if primary and log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file, mode="w")
        fh.setLevel(level)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    return root
