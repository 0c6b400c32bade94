"""Host collective: the inter-host gradient exchange over TCP (the JAX
package's ``parallel/hostcomm.py``).

The multihost elastic runtime runs one OS process a "host"
(``resilience.multihost``), each a single-process trainer on its own
device (on one card, every host process uses ``cuda:0``: no NCCL is
involved), and moves the inter-host 1-bit exchange over a host-side
transport: the source paper's own setting, commodity TCP between hosts
(the reference's hand-rolled socket master and node). It is also where
host loss becomes observable: a SIGKILLed rank surfaces as an EOF or a
timeout on a socket.

Topology: a star. Rank 0 conducts: every peer ships its compressed
planes up, rank 0 concatenates the ``hosts`` messages and broadcasts
the bundle back, so every rank notices a dead world within one step.

Failure contract: the exchange runs inside the train step, between the
backward and the optimizer's update, and never raises there: on a
socket error it marks the channel ``lost`` and returns zeros of the
right shape. The trainer checks ``channel.lost`` at the next step
boundary, discards the step that consumed them and vacates through the
preempt path without saving, so the relaunch resumes from the last
digest-verified checkpoint generation: the run after a shrink is
bitwise a fresh resume at that world.

Lockstep: every rank issues the same sequence of ``allgather`` calls
with the same ``tag``; the conductor checks the tags, and a mismatch is
divergence (the channel is lost). ``HostSignCompress`` issues one
allgather a step, tagged by a step counter.

A host socket cannot be recorded in a CUDA graph (JAX runs it from the
compiled step through ``io_callback``): under the host channel a
captured dispatch (``scan_steps > 1``, ``device_data``) raises.
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..train.optim import SignCompress

log = logging.getLogger(__name__)

# frame header: (rank, tag, payload_len)
_HDR = struct.Struct("!IIQ")
_LEN = struct.Struct("!Q")
_HELLO_TAG = 0xFFFFFFFF


class HostLostError(ConnectionError):
    """A peer host vanished mid-exchange (EOF/timeout/reset). Carries
    ``lost_ranks`` when the conductor could attribute the loss."""

    def __init__(self, message: str, lost_ranks: Optional[List[int]] = None):
        super().__init__(message)
        self.lost_ranks = list(lost_ranks or [])


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise HostLostError(
                f"peer closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf.extend(chunk)
    return bytes(buf)


class HostChannel:
    """One rank's endpoint of the star-topology host collective.

    ``start()`` establishes the full-world mesh of connections (rank 0
    binds/listens/accepts; peers connect with jittered retries — the
    conductor races to bind, so a refused connect is the expected
    transient). ``allgather(payload, tag)`` is the one collective: every
    rank contributes a byte string, every rank receives all ``hosts``
    payloads in rank order. ``hosts == 1`` needs no sockets at all.

    Byte counters (``bytes_sent``/``bytes_received``) account the real
    framed traffic for the observability split; ``lost`` latches on the
    first failure (with ``lost_ranks`` when attributable) and every
    later call fails fast — a half-dead world must vacate, not limp.

    Thread safety: ``allgather`` is meant for one caller (the train
    step's exchange); ``mark_lost`` may race it from a monitor thread,
    hence the small lock around the latch.
    """

    def __init__(
        self,
        rank: int,
        hosts: int,
        port: int,
        *,
        host: str = "127.0.0.1",
        timeout_s: float = 60.0,
        connect_retries: int = 20,
        connect_backoff_s: float = 0.1,
    ):
        if hosts < 1 or not 0 <= rank < hosts:
            raise ValueError(f"rank {rank} out of range for {hosts} host(s)")
        self.rank = int(rank)
        self.hosts = int(hosts)
        self.port = int(port)
        self.host = host
        self.timeout_s = float(timeout_s)
        self.connect_retries = int(connect_retries)
        self.connect_backoff_s = float(connect_backoff_s)
        self.bytes_sent = 0
        self.bytes_received = 0
        self._lock = threading.Lock()
        self._lost = False
        self._lost_reason = ""
        self.lost_ranks: List[int] = []
        self._peers: Dict[int, socket.socket] = {}  # conductor: rank->sock
        self._up: Optional[socket.socket] = None    # peer: link to rank 0
        self._srv: Optional[socket.socket] = None
        self._started = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "HostChannel":
        if self._started or self.hosts == 1:
            self._started = True
            return self
        if self.rank == 0:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((self.host, self.port))
            srv.listen(self.hosts)
            srv.settimeout(self.timeout_s)
            self._srv = srv
            try:
                while len(self._peers) < self.hosts - 1:
                    conn, _ = srv.accept()
                    conn.settimeout(self.timeout_s)
                    rank, tag, n = _HDR.unpack(
                        _recv_exact(conn, _HDR.size)
                    )
                    if tag != _HELLO_TAG or not 1 <= rank < self.hosts:
                        raise HostLostError(
                            f"bad hello (rank={rank}, tag={tag:#x}) — "
                            "stale peer from a previous generation?"
                        )
                    if rank in self._peers:
                        raise HostLostError(
                            f"rank {rank} connected twice (rank collision)"
                        )
                    self._peers[rank] = conn
            except (OSError, HostLostError) as e:
                self.mark_lost(f"world never formed: {e}")
                raise HostLostError(
                    f"conductor: only {len(self._peers) + 1}/{self.hosts} "
                    f"hosts joined within {self.timeout_s}s: {e}"
                ) from e
        else:
            from ..utils.transfer import _connect_with_retries

            try:
                self._up = _connect_with_retries(
                    self.host, self.port, timeout=self.timeout_s,
                    retries=self.connect_retries,
                    backoff_s=self.connect_backoff_s,
                )
                self._up.settimeout(self.timeout_s)
                self._up.sendall(_HDR.pack(self.rank, _HELLO_TAG, 0))
            except OSError as e:
                self.mark_lost(f"could not join world: {e}")
                raise HostLostError(
                    f"rank {self.rank}: conductor {self.host}:{self.port} "
                    f"unreachable: {e}"
                ) from e
        self._started = True
        log.info(
            "host collective up: rank %d/%d via %s:%d",
            self.rank, self.hosts, self.host, self.port,
        )
        return self

    def close(self) -> None:
        for s in [self._up, self._srv, *self._peers.values()]:
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._peers.clear()
        self._up = None
        self._srv = None

    # -- loss latch --------------------------------------------------------

    @property
    def lost(self) -> bool:
        with self._lock:
            return self._lost

    @property
    def lost_reason(self) -> str:
        with self._lock:
            return self._lost_reason

    def mark_lost(self, reason: str, ranks: Optional[List[int]] = None):
        with self._lock:
            if not self._lost:
                self._lost = True
                self._lost_reason = reason
                self.lost_ranks = list(ranks or [])
                log.error(
                    "host collective lost (rank %d/%d): %s",
                    self.rank, self.hosts, reason,
                )

    # -- the collective ----------------------------------------------------

    def allgather(self, payload: bytes, tag: int = 0) -> List[bytes]:
        """Every rank contributes ``payload``; returns all ``hosts``
        payloads in rank order (identical list on every rank). Raises
        :class:`HostLostError` on any transport failure (after latching
        ``lost``); the train step's exchange catches it (module
        docstring)."""
        if self.hosts == 1:
            return [payload]
        if not self._started:
            raise RuntimeError("HostChannel.start() not called")
        if self.lost:
            raise HostLostError(f"world already lost: {self.lost_reason}")
        tag &= 0xFFFFFFFF
        try:
            if self.rank == 0:
                return self._conduct(payload, tag)
            return self._follow(payload, tag)
        except HostLostError:
            raise
        except OSError as e:
            self.mark_lost(f"{type(e).__name__}: {e}")
            raise HostLostError(
                f"rank {self.rank}: exchange failed: {e}"
            ) from e

    def _conduct(self, payload: bytes, tag: int) -> List[bytes]:
        parts: List[Optional[bytes]] = [None] * self.hosts
        parts[0] = payload
        for rank, sock in self._peers.items():
            try:
                r, t, n = _HDR.unpack(_recv_exact(sock, _HDR.size))
                if r != rank or t != tag:
                    raise HostLostError(
                        f"schedule divergence: rank {rank} sent "
                        f"(rank={r}, tag={t}), expected tag {tag}"
                    )
                parts[rank] = _recv_exact(sock, n)
                self.bytes_received += _HDR.size + n
            except (OSError, HostLostError) as e:
                self.mark_lost(
                    f"host {rank} lost mid-gather: {e}", ranks=[rank]
                )
                raise HostLostError(
                    f"conductor: host {rank} lost: {e}", lost_ranks=[rank]
                ) from e
        bundle = b"".join(
            _LEN.pack(len(p)) + p for p in parts  # type: ignore[arg-type]
        )
        hdr = _HDR.pack(0, tag, len(bundle))
        for rank, sock in self._peers.items():
            try:
                sock.sendall(hdr + bundle)
                self.bytes_sent += len(hdr) + len(bundle)
            except OSError as e:
                self.mark_lost(
                    f"host {rank} lost mid-broadcast: {e}", ranks=[rank]
                )
                raise HostLostError(
                    f"conductor: host {rank} lost: {e}", lost_ranks=[rank]
                ) from e
        return parts  # type: ignore[return-value]

    def _follow(self, payload: bytes, tag: int) -> List[bytes]:
        assert self._up is not None
        self._up.sendall(_HDR.pack(self.rank, tag, len(payload)) + payload)
        self.bytes_sent += _HDR.size + len(payload)
        r, t, n = _HDR.unpack(_recv_exact(self._up, _HDR.size))
        if r != 0 or t != tag:
            self.mark_lost(
                f"schedule divergence: conductor sent (rank={r}, tag={t}), "
                f"expected tag {tag}"
            )
            raise HostLostError("schedule divergence on broadcast")
        bundle = _recv_exact(self._up, n)
        self.bytes_received += _HDR.size + n
        parts, off = [], 0
        for _ in range(self.hosts):
            (m,) = _LEN.unpack(bundle[off:off + _LEN.size])
            off += _LEN.size
            parts.append(bundle[off:off + m])
            off += m
        if off != n:
            self.mark_lost(f"bundle framing off ({off} != {n})")
            raise HostLostError("corrupt broadcast bundle")
        return parts


def allgather_rows(
    channel: HostChannel, row: np.ndarray, *, tag: int = 0
) -> np.ndarray:
    """Stack every host's equally-shaped ``row`` into ``(hosts, *shape)``
    (rank order). The checkpoint-boundary EF-row sync: each rank's
    compress state holds only its own row; the primary needs the full
    matrix before saving so a resume at ANY host count can re-fold it
    (parallel/remesh). Raises HostLostError on transport failure — the
    caller is at a step boundary, where raising is safe."""
    row = np.ascontiguousarray(row)
    parts = channel.allgather(row.tobytes(), tag=tag)
    out = np.stack([
        np.frombuffer(p, dtype=row.dtype).reshape(row.shape) for p in parts
    ])
    return out


# -- the host-side compressed gradient transform ----------------------------


class HostSignCompress(SignCompress):
    """The 1-bit inter-host gradient exchange as the optimizer's
    gradient transform (the JAX ``host_sign_compress``): the
    ``train.optim.SignCompress`` contract carried over the host
    collective instead of a process group, run after clipping and before
    the base optimizer's update (``make_optimizer(grad_transform=)``).

    One phase: each host sign-compresses its (error-corrected) padded
    flat gradient into bucket planes and scales, the star allgather
    moves every host's message, and each host decodes and combines all
    ``hosts`` contributions (the mean of scale * sign for ``sign_ef``,
    the majority vote for ``sign``). So only the worker-side error
    feedback exists: ``ef_residual2`` stays zero, kept at the flat
    layout so that ``parallel.remesh`` folds the rows across host counts.

    The state is this host's row of JAX's ``(hosts, padded)`` /
    ``(hosts, seg)`` ``SignCompressState`` (``rank`` is the row); the
    trainer gathers the rows at checkpoints (``allgather_rows``). Every
    host combines the same gathered bytes, so the updates, and the
    trajectories, are bitwise equal across the world. A failed exchange
    latches ``channel.lost`` and combines zeros (module docstring). The
    rows' ``tensors``, ``state_dict`` and ``load_state_dict`` are
    ``SignCompress``'s."""

    def __init__(self, *, mode: str, order, channel: HostChannel,
                 bucket_size: int = 1024, chunks: int = 4):
        import torch

        from ..ops.comm_compress import make_plan

        if mode not in ("sign", "sign_ef"):
            raise ValueError(
                f"unknown compression mode {mode!r} (have: sign, sign_ef)")
        self.mode = mode
        self.order = order
        self.group = self.local_group = None
        self.channel = channel
        self.hosts, self.rank = channel.hosts, channel.rank
        self.plan = make_plan(order.n_params, world=self.hosts, mode=mode,
                              bucket_size=bucket_size, chunks=chunks)
        self.wire = None           # the channel counts its own bytes
        self.step_tag = 0          # lockstep tag: every rank steps in unison
        self.ef_residual = self.ef_residual2 = None
        if mode == "sign_ef":
            device = order.entries[0][1].device
            self.ef_residual = torch.zeros(self.plan.padded, device=device)
            self.ef_residual2 = torch.zeros(self.plan.seg, device=device)

    def _exchange(self, planes, scale):
        """Every host's planes and scales, ``(hosts, nb, words)`` int32
        and ``(hosts, nb)`` fp32 on this host's device; zeros once the
        channel is lost (never raises)."""
        import torch

        hosts, nb, words = self.hosts, planes.shape[0], planes.shape[1]
        zeros = (np.zeros((hosts, nb, words), np.int32),
                 np.zeros((hosts, nb), np.float32))
        out = zeros
        if not self.channel.lost:
            tag = self.step_tag
            self.step_tag += 1
            p_np = planes.cpu().numpy()
            s_np = scale.cpu().numpy().astype(np.float32)
            p_bytes, s_bytes = p_np.nbytes, s_np.nbytes
            try:
                parts = self.channel.allgather(
                    p_np.tobytes() + s_np.tobytes(), tag=tag)
                g_planes = np.empty((hosts, nb, words), np.int32)
                g_scales = np.empty((hosts, nb), np.float32)
                for h, part in enumerate(parts):
                    if len(part) != p_bytes + s_bytes:
                        raise HostLostError(
                            f"host {h} message {len(part)}B, expected "
                            f"{p_bytes + s_bytes}B")
                    g_planes[h] = np.frombuffer(
                        part[:p_bytes], np.int32).reshape(nb, words)
                    g_scales[h] = np.frombuffer(part[p_bytes:], np.float32)
                out = (g_planes, g_scales)
            except Exception as e:   # never raise mid-step (docstring)
                self.channel.mark_lost(f"{type(e).__name__}: {e}")
        return (torch.from_numpy(out[0]).to(planes.device),
                torch.from_numpy(out[1]).to(planes.device))

    def __call__(self, params, grads):
        from ..ops.bitpack import unpack_bits
        from ..ops.comm_compress import (
            _signs,
            compress_buckets,
            decompress_buckets,
            pad_flat,
        )

        plan, b = self.plan, self.plan.bucket_size
        flat = pad_flat(self.order.flatten(dict(zip(params, grads))), plan)
        corrected = (flat + self.ef_residual if self.mode == "sign_ef"
                     else flat)
        x = corrected.reshape(self.hosts * plan.nb, b)
        planes, scale = compress_buckets(x)
        sent = decompress_buckets(planes, scale, b).reshape(plan.padded)
        g_planes, g_scales = self._exchange(planes, scale)
        if self.mode == "sign":
            votes = unpack_bits(g_planes, b).sum(dim=0)
            combined = _signs(votes) * g_scales.mean(dim=0)[..., None]
        else:
            combined = decompress_buckets(g_planes, g_scales, b).mean(dim=0)
        combined = combined.reshape(plan.padded)
        if self.mode == "sign_ef":
            e1 = corrected - sent
            e1[plan.n_params:] = 0.0
            self.ef_residual.copy_(e1)
        update = self.order.unflatten(combined[:plan.n_params])
        return [update[p] for p in params]


host_sign_compress = HostSignCompress   # the JAX package's name
