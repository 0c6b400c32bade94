"""Checkpoint shipping between machines over TCP.

Capability parity with the reference's hand-rolled master/node socket pair
(mnist change master.py:117-124 binds/listens and replies with the file
size; mnist change node.py:105-107 connects and ships the checkpoint
filename after saving — code that is broken in the reference, SURVEY §2.8).
The port of the JAX package's ``utils/transfer.py``, protocol and all. With
a shared filesystem the checkpoint directory is the normal path (see
utils/checkpoint.py); this utility covers the no-shared-storage case the
reference's socket pair addressed, with a correct length-prefixed protocol
instead of the reference's filename/size handshake.

Protocol (all big-endian):
    8-byte name length | name utf-8 | 8-byte payload length
    | 32-byte sha256(payload) | payload bytes
The receiver verifies the digest BEFORE the atomic tmp→rename (a
truncated-but-length-matching or bit-flipped ship is rejected, never
silently accepted as a checkpoint), then replies with the 8-byte payload
length + its own 32-byte digest of the written bytes as the ack; the
sender verifies both. Same sha256 the checkpoint integrity layer records
in checkpoint_meta.json (utils/checkpoint.file_digest).
"""

from __future__ import annotations

import hashlib
import logging
import os
import socket
import struct
import time
from typing import Tuple

log = logging.getLogger(__name__)

_LEN = struct.Struct(">Q")
_DIGEST_BYTES = hashlib.sha256().digest_size  # 32

#: connect retries of this process (the JAX package counts them in its
#: metrics registry as ``transfer_retries_total``)
connect_retries = 0


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-transfer")
        buf.extend(chunk)
    return bytes(buf)


def _connect_with_retries(
    host: str, port: int, *, timeout: float,
    retries: int, backoff_s: float,
) -> socket.socket:
    """create_connection with jittered-exponential connect retries —
    the receiver races to bind/listen, so a refused or timed-out
    connect is the expected transient, not an error (the reference's
    node just crashed here). Fatal address errors (gaierror) are not
    retried."""
    global connect_retries
    from ..resilience.policy import RetryPolicy

    policy = RetryPolicy(
        max_restarts=retries, base_backoff_s=backoff_s, max_backoff_s=10.0
    )
    last: Exception = ConnectionError("no attempt made")
    for attempt in range(retries + 1):
        if attempt:
            delay = policy.backoff(attempt)
            connect_retries += 1
            log.warning(
                "connect to %s:%d failed (%s: %s); retry %d/%d in %.2fs",
                host, port, type(last).__name__, last, attempt, retries,
                delay,
            )
            time.sleep(delay)
        try:
            return socket.create_connection((host, port), timeout=timeout)
        except (ConnectionError, TimeoutError, socket.timeout) as e:
            last = e
    raise ConnectionError(
        f"could not connect to {host}:{port} after {retries + 1} "
        f"attempts (timeout {timeout}s each): "
        f"{type(last).__name__}: {last}"
    ) from last


def send_file(
    path: str, host: str, port: int, *,
    timeout: float = 30.0, retries: int = 3, backoff_s: float = 0.5,
) -> int:
    """Ship one file to a listening receiver; returns bytes sent.

    Connect failures retry with jittered backoff; a peer that stalls
    mid-transfer surfaces as a ``TimeoutError`` naming the peer, the
    file and the deadline instead of a bare ``socket.timeout``. The ack
    must echo both the payload length and its sha256 — a receiver that
    stored different bytes fails the ship loudly on this side too."""
    name = os.path.basename(path).encode()
    with open(path, "rb") as f:
        payload = f.read()
    # Hash the bytes actually being shipped (one read, no TOCTOU with a
    # concurrent rewrite) — the same sha256 utils/checkpoint.file_digest
    # records in checkpoint_meta.json, so a receiver-side resume can
    # cross-check the shipped artifact against its meta.
    digest = hashlib.sha256(payload).digest()
    with _connect_with_retries(
        host, port, timeout=timeout, retries=retries, backoff_s=backoff_s
    ) as s:
        try:
            s.sendall(
                _LEN.pack(len(name)) + name + _LEN.pack(len(payload))
                + digest
            )
            s.sendall(payload)
            ack = _LEN.unpack(_recv_exact(s, _LEN.size))[0]
            ack_digest = _recv_exact(s, _DIGEST_BYTES)
        except (TimeoutError, socket.timeout) as e:
            raise TimeoutError(
                f"{host}:{port} stalled mid-transfer of {path} "
                f"({len(payload)} bytes, timeout {timeout}s)"
            ) from e
    if ack != len(payload):
        raise IOError(f"receiver acked {ack} bytes, sent {len(payload)}")
    if ack_digest != digest:
        raise IOError(
            f"receiver acked sha256 {ack_digest.hex()[:16]}…, sent "
            f"{digest.hex()[:16]}… — stored bytes differ from {path}"
        )
    log.info("shipped %s (%d bytes) to %s:%d", path, len(payload), host, port)
    return len(payload)


def receive_file(
    out_dir: str, port: int, *, host: str = "", timeout: float = 120.0
) -> Tuple[str, int]:
    """Accept one file; returns (path, bytes). Blocks until a sender
    connects (the master's accept loop in the reference)."""
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        srv.settimeout(timeout)
        try:
            conn, addr = srv.accept()
        except (TimeoutError, socket.timeout) as e:
            raise TimeoutError(
                f"no sender connected to port {port} within {timeout}s"
            ) from e
        with conn:
            conn.settimeout(timeout)
            try:
                name_len = _LEN.unpack(_recv_exact(conn, _LEN.size))[0]
                if name_len > 4096:
                    raise IOError(f"unreasonable name length {name_len}")
                name = os.path.basename(_recv_exact(conn, name_len).decode())
                size = _LEN.unpack(_recv_exact(conn, _LEN.size))[0]
                expected = _recv_exact(conn, _DIGEST_BYTES)
                payload = _recv_exact(conn, size)
            except (TimeoutError, socket.timeout) as e:
                raise TimeoutError(
                    f"sender {addr} stalled mid-transfer into {out_dir} "
                    f"(timeout {timeout}s)"
                ) from e
            # Verify BEFORE the atomic rename: a corrupt ship must never
            # become the latest-checkpoint file a resume would trust.
            got = hashlib.sha256(payload).digest()
            if got != expected:
                raise IOError(
                    f"sha256 mismatch receiving {name} from {addr}: got "
                    f"{got.hex()[:16]}…, sender declared "
                    f"{expected.hex()[:16]}… ({size} bytes) — rejecting "
                    "before rename"
                )
            out_path = os.path.join(out_dir, name)
            tmp = out_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, out_path)
            conn.sendall(_LEN.pack(size) + got)  # length + digest ack
    log.info("received %s (%d bytes) from %s", out_path, size, addr)
    return out_path, size


def ship_checkpoint(ckpt_dir: str, host: str, port: int) -> int:
    """Send the latest checkpoint artifact (the node side of the pair)."""
    from .checkpoint import LATEST

    return send_file(os.path.join(ckpt_dir, LATEST), host, port)


def receive_checkpoint(ckpt_dir: str, port: int, **kw) -> str:
    """Receive a checkpoint into ``ckpt_dir`` (the master side); the file
    lands under the standard latest-checkpoint name, ready for
    load_checkpoint + resume."""
    path, _ = receive_file(ckpt_dir, port, **kw)
    return path
