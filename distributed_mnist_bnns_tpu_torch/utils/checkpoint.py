"""Checkpoints in the JAX package's format: one writer, a barrier, digests
and generations.

The port of the JAX package's ``utils/checkpoint.py`` without flax: a
checkpoint is the msgpack (``utils.msgpack.to_bytes``) of a train-state
tree in flax's layout (``interop.train_state_to_jax``: ``{step, params,
batch_stats, opt_state}``), so the JAX ``load_checkpoint`` restores a
port checkpoint and the port restores a JAX one. The file names are
JAX's:

  checkpoint.msgpack            the latest, written atomically (tmp, then
                                rename)
  checkpoint_meta.json          epoch, step, sha256 digest, generation,
                                the generation ledger (newest first) and
                                the caller's extra keys; written
                                atomically too
  checkpoint_gen_<g>.msgpack    the newest ``keep`` generations, hardlinks
                                of the latest (a copy where the
                                filesystem refuses links)
  model_best.msgpack            a copy when ``is_best``
  checkpoint_epoch_<N>.msgpack  a copy per epoch with ``save_all``

``load_checkpoint_resilient`` verifies the digest and rolls back
generation by generation past a truncated or corrupt file; when none
loads it raises ``CheckpointCorruptionError``. Intact bytes that do not
fit the caller's template raise ``CheckpointTemplateMismatch`` (the
model or the optimizer changed, not the file), and leaves of other
shapes ``CheckpointWorldMismatch``.

Rank 0 of a ``torch.distributed`` group writes (``is_primary_host``);
every rank then passes a barrier, an all-reduce of a zero on the group's
device (the CPU under gloo, the current card under NCCL). A tree is
copied to host memory before it is written: ``AsyncCheckpointer`` takes
that copy before its thread starts, since a thread reading CUDA tensors
would race the next step's in-place update.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import msgpack
from .logging_utils import is_primary_host

log = logging.getLogger(__name__)

LATEST = "checkpoint.msgpack"
BEST = "model_best.msgpack"
META = "checkpoint_meta.json"
GEN_PREFIX = "checkpoint_gen_"
DEFAULT_KEEP_GENERATIONS = 3


class CheckpointCorruptionError(RuntimeError):
    """No checkpoint generation under the directory could be verified
    and read."""


class CheckpointTemplateMismatch(ValueError):
    """A digest-verified checkpoint does not fit the caller's template: the
    model or the optimizer changed. A ValueError, so the retry policy
    takes it as fatal (a rollback would discard a healthy run)."""


class CheckpointWorldMismatch(ValueError):
    """A digest-verified checkpoint has the template's structure but leaves
    of other shapes, as the ``(world, ...)`` error-feedback rows of a run
    at another data-parallel world."""


def _barrier() -> None:
    """Every rank of the default group waits here (no-op without one)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    if dist.get_world_size() <= 1:
        return
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    dist.all_reduce(torch.zeros(1, device=device))


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` in host memory: tensors as numpy arrays
    (bfloat16 as CPU tensors), copied even when they already lie on the
    CPU."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def _write_meta(path: str, meta: dict) -> None:
    """The meta sidecar, atomically: it decides which file to trust."""
    target = os.path.join(path, META)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, target)


def _link_or_copy(src: str, dst: str) -> None:
    """Hardlink ``src`` to ``dst`` (replacing ``dst``); a copy where the
    filesystem has no links."""
    try:
        if os.path.exists(dst):
            os.remove(dst)
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def _write_checkpoint(host_tree: Any, path: str, is_best: bool,
                      epoch: Optional[int], save_all: bool,
                      extra_meta: Optional[dict],
                      keep_generations: Optional[int] = None) -> str:
    """Serialize a host tree and write it with its meta and generation (rank
    0 only); host work only, so it runs inline or on a thread."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, LATEST)
    if not is_primary_host():
        return target
    keep = (DEFAULT_KEEP_GENERATIONS if keep_generations is None
            else max(int(keep_generations), 1))
    data = msgpack.to_bytes(host_tree)
    digest = hashlib.sha256(data).hexdigest()
    prev_meta = read_meta(path)
    prev_gen = prev_meta.get("generation")
    generation = int(prev_gen) + 1 if prev_gen is not None else 0
    step = (int(np.asarray(host_tree["step"]))
            if isinstance(host_tree, dict) and "step" in host_tree else None)
    tmp = target + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, target)
    meta = {"epoch": epoch, "step": step, "digest": digest,
            "generation": generation}
    meta.update(extra_meta or {})
    gen_file = f"{GEN_PREFIX}{generation}.msgpack"
    _link_or_copy(target, os.path.join(path, gen_file))
    generations = [{"file": gen_file, **meta}]
    generations += [g for g in (prev_meta.get("generations") or [])
                    if g.get("file") and g["file"] != gen_file]
    for stale in generations[keep:]:
        try:
            os.remove(os.path.join(path, stale["file"]))
        except OSError as e:
            log.warning("could not prune generation %s: %s", stale["file"], e)
    meta["generations"] = generations[:keep]
    _write_meta(path, meta)
    if is_best:
        shutil.copyfile(target, os.path.join(path, BEST))
    if save_all and epoch is not None:
        shutil.copyfile(target,
                        os.path.join(path, f"checkpoint_epoch_{epoch}.msgpack"))
    log.info("saved checkpoint to %s (epoch=%s best=%s)", target, epoch,
             is_best)
    return target


def save_checkpoint(tree: Any, path: str, *, is_best: bool = False,
                    epoch: Optional[int] = None, save_all: bool = False,
                    extra_meta: Optional[dict] = None,
                    keep_generations: Optional[int] = None) -> str:
    """Write the latest checkpoint (and the best / per-epoch copies); rank
    0 writes, every rank passes the trailing barrier."""
    target = _write_checkpoint(_to_host(tree), path, is_best, epoch,
                               save_all, extra_meta, keep_generations)
    _barrier()
    return target


class AsyncCheckpointer:
    """Checkpointing that overlaps serialization and disk IO with training.

    ``save`` copies the tree to host memory at once, then hands the
    serialization, the atomic write and the copies to one background
    thread. One write is in flight at a time (a new ``save`` first joins
    the last, so the files land in call order); ``wait`` joins it,
    re-raises its error and passes the barrier."""

    def __init__(self):
        from concurrent.futures import ThreadPoolExecutor

        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="ckpt-writer")
        self._inflight = None

    def save(self, tree: Any, path: str, *, is_best: bool = False,
             epoch: Optional[int] = None, save_all: bool = False,
             extra_meta: Optional[dict] = None,
             keep_generations: Optional[int] = None) -> str:
        self.wait()
        host_tree = _to_host(tree)
        self._inflight = self._executor.submit(
            _write_checkpoint, host_tree, path, is_best, epoch, save_all,
            extra_meta, keep_generations)
        return os.path.join(path, LATEST)

    def wait(self) -> None:
        if self._inflight is not None:
            inflight, self._inflight = self._inflight, None
            inflight.result()
            _barrier()

    def close(self) -> None:
        self.wait()
        self._executor.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _restore(template: Any, state: Any, path: str = "") -> Any:
    """``state`` in the structure of ``template`` (flax
    ``from_state_dict``): every dict of the template must be a dict of the
    same keys in ``state``; leaves are taken from ``state``."""
    if isinstance(template, dict):
        if not isinstance(state, dict):
            raise ValueError(f"{path or 'root'}: the checkpoint holds a "
                             f"{type(state).__name__}, not a dict")
        if set(map(str, template)) != set(state):
            missing = sorted(set(map(str, template)) - set(state))
            extra = sorted(set(state) - set(map(str, template)))
            raise ValueError(f"{path or 'root'}: keys differ (missing "
                             f"{missing}, unexpected {extra})")
        return {k: _restore(v, state[str(k)], f"{path}['{k}']")
                for k, v in template.items()}
    if isinstance(state, dict):
        raise ValueError(f"{path}: the checkpoint holds a dict where the "
                         "template has a leaf")
    return state


def _shape(x: Any) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def _leaves(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}['{k}']")
    else:
        yield path, tree


def load_checkpoint(template: Any, path: str, *, best: bool = False) -> Any:
    """The latest (``best``: the best) checkpoint under ``path`` in the
    structure of ``template``; arrays as numpy (bfloat16 as tensors)."""
    fname = os.path.join(path, BEST if best else LATEST)
    with open(fname, "rb") as f:
        data = f.read()
    restored = _restore(template, msgpack.from_bytes(data))
    _barrier()
    return restored


def read_meta(path: str) -> dict:
    try:
        with open(os.path.join(path, META)) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}
    except json.JSONDecodeError as e:
        log.warning("unreadable checkpoint meta under %s: %s", path, e)
        return {}


def latest_exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, LATEST))


def file_digest(path: str) -> str:
    """The sha256 of a file, read in 1 MiB pieces."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify_checkpoint(path: str, *, file: str = LATEST,
                      digest: Optional[str] = None) -> bool:
    """True iff ``file`` under ``path`` matches ``digest`` (default: the
    meta's); a checkpoint with no digest recorded verifies."""
    fpath = os.path.join(path, file)
    if not os.path.exists(fpath):
        return False
    if digest is None:
        digest = read_meta(path).get("digest")
    if not digest:
        return True
    return file_digest(fpath) == digest


def shape_mismatches(template: Any, restored: Any) -> List[str]:
    """``["path: checkpoint (8, 128) vs run (4, 256)", ...]`` for every
    leaf whose shape differs between two trees of one structure."""
    out = []
    for (p, t), (_, r) in zip(_leaves(template), _leaves(restored)):
        if _shape(t) != _shape(r):
            out.append(f"{p}: checkpoint {_shape(r)} vs run {_shape(t)}")
    return out


def load_checkpoint_resilient(template: Any, path: str, *,
                              on_shape_mismatch: str = "raise"
                              ) -> Tuple[Any, dict]:
    """The newest generation under ``path`` that verifies and fits
    ``template``, rolling back past truncated or corrupt files.

    Candidates, newest first: the latest file against the meta's digest,
    then each record of the generation ledger. Returns ``(tree, info)``,
    ``info`` with ``file``, ``digest_verified`` (None: no digest
    recorded), ``rolled_back``, ``errors`` (what was skipped),
    ``shape_mismatches`` and ``meta`` (the record of the generation
    restored). Raises ``CheckpointCorruptionError`` when nothing loads,
    ``CheckpointTemplateMismatch`` for verified bytes of another
    structure, and ``CheckpointWorldMismatch`` for leaves of other shapes
    (``on_shape_mismatch="return"`` hands them back instead)."""
    if on_shape_mismatch not in ("raise", "return"):
        raise ValueError(f"on_shape_mismatch must be 'raise' or 'return', "
                         f"got {on_shape_mismatch!r}")
    meta = read_meta(path)
    candidates = []
    if os.path.exists(os.path.join(path, LATEST)):
        candidates.append({"file": LATEST, **{k: v for k, v in meta.items()
                                              if k != "generations"}})
    for record in meta.get("generations") or []:
        if record.get("file") and os.path.exists(
                os.path.join(path, record["file"])):
            candidates.append(record)
    errors: List[str] = []
    tried: List[str] = []   # rejected files (the latest and the newest
    #                         generation are one inode: hash it once)
    for i, record in enumerate(candidates):
        fname = record["file"]
        fpath = os.path.join(path, fname)
        try:
            if any(os.path.samefile(fpath, t) for t in tried):
                errors.append(f"{fname}: same file as a rejected candidate")
                continue
        except OSError:
            pass
        try:
            with open(fpath, "rb") as f:
                data = f.read()
        except OSError as e:
            errors.append(f"{fname}: {type(e).__name__}: {e}")
            continue
        digest = record.get("digest")
        verified: Optional[bool] = None
        if digest:
            if hashlib.sha256(data).hexdigest() != digest:
                errors.append(f"{fname}: digest mismatch")
                tried.append(fpath)
                continue
            verified = True
        try:
            decoded = msgpack.from_bytes(data)
        except Exception as e:
            errors.append(f"{fname}: {type(e).__name__}: {e}")
            tried.append(fpath)
            continue
        try:
            restored = _restore(template, decoded)
        except ValueError as e:
            if verified:
                raise CheckpointTemplateMismatch(
                    f"{fname} under {path} is digest-verified but does not "
                    f"fit the trainer's state ({e}): the model or the "
                    "optimizer differs from the checkpoint's") from e
            errors.append(f"{fname}: {type(e).__name__}: {e}")
            tried.append(fpath)
            continue
        mismatches = shape_mismatches(template, restored)
        if mismatches and on_shape_mismatch == "raise":
            world = record.get("world_size")
            raise CheckpointWorldMismatch(
                f"{fname} under {path} is intact but {len(mismatches)} "
                f"leaf(s) differ in shape from the trainer's state (e.g. "
                f"{'; '.join(mismatches[:3])}); the checkpoint's meta "
                f"records world_size={world}. Resume at the checkpoint's "
                "world, or with elastic=True (TrainConfig.elastic), which "
                "re-places the (world, ...) rows of the 1-bit exchange; "
                "another model needs a fresh checkpoint dir")
        if errors:
            log.warning("checkpoint rollback: restored %s after skipping %s",
                        fname, "; ".join(errors))
        _barrier()
        return restored, {"file": fname, "digest_verified": verified,
                          "rolled_back": i > 0, "errors": errors,
                          "shape_mismatches": mismatches,
                          "meta": dict(record)}
    raise CheckpointCorruptionError(
        f"no loadable checkpoint under {path}: "
        + ("; ".join(errors) if errors else "no checkpoint files"))
