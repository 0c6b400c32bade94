"""Checkpoint shipping over TCP (``utils/transfer.py``), the cases of the
JAX package's ``tests/test_transfer.py`` and its transfer satellites in
``tests/test_resilience.py``: a round trip on localhost; a corrupt ship
rejected before the atomic rename; a bad ack digest rejected by the
sender; a checkpoint shipped, received into another directory and
resumed there (with its meta, the run continues bitwise); connect
retries that end in a clear error (and count); a receive timeout that
names the port. Ports are free ones the OS hands out, so the suite's
parallel workers never meet."""

import hashlib
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from distributed_mnist_bnns_tpu_torch.data import load_mnist
from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer
from distributed_mnist_bnns_tpu_torch.utils import checkpoint as ck
from distributed_mnist_bnns_tpu_torch.utils import transfer
from distributed_mnist_bnns_tpu_torch.utils.transfer import (
    receive_checkpoint,
    receive_file,
    send_file,
    ship_checkpoint,
)
from tests import torch_dp_util as util


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _receive_in_thread(fn, *args, **kw):
    result = {}

    def run():
        try:
            result["out"] = fn(*args, **kw)
        except Exception as e:   # handed to the test
            result["error"] = e

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.2)   # let the listener bind
    return t, result


def test_send_receive_roundtrip(tmp_path):
    src = tmp_path / "artifact.bin"
    payload = bytes(range(256)) * 1000
    src.write_bytes(payload)
    port = _free_port()
    t, result = _receive_in_thread(receive_file, str(tmp_path / "inbox"),
                                   port)
    sent = send_file(str(src), "127.0.0.1", port)
    t.join(timeout=10)
    assert sent == len(payload) == result["out"][1]
    assert (tmp_path / "inbox" / "artifact.bin").read_bytes() == payload


def test_corrupt_ship_rejected_before_rename(tmp_path):
    out_dir = tmp_path / "inbox"
    port = _free_port()
    t, result = _receive_in_thread(receive_file, str(out_dir), port,
                                   timeout=10)
    payload = bytes(range(256)) * 64
    corrupt = bytes(b ^ 0xFF for b in payload)
    digest = hashlib.sha256(payload).digest()
    q = struct.Struct(">Q")
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(q.pack(4) + b"f.ck" + q.pack(len(payload)) + digest)
        s.sendall(corrupt)
    t.join(timeout=10)
    assert isinstance(result.get("error"), IOError)
    assert "sha256 mismatch" in str(result["error"])
    assert not (out_dir / "f.ck").exists()
    assert not (out_dir / "f.ck.tmp").exists()


def test_sender_rejects_wrong_ack_digest(tmp_path):
    src = tmp_path / "artifact.bin"
    src.write_bytes(b"payload-bytes" * 100)
    q = struct.Struct(">Q")
    ready = threading.Event()
    port = _free_port()

    def read(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            assert chunk
            buf += chunk
        return buf

    def fake_receiver():
        with socket.socket() as srv:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("127.0.0.1", port))
            srv.listen(1)
            srv.settimeout(10)
            ready.set()
            conn, _ = srv.accept()
            with conn:
                conn.settimeout(10)
                read(conn, q.unpack(read(conn, 8))[0])
                size = q.unpack(read(conn, 8))[0]
                read(conn, 32)
                read(conn, size)
                conn.sendall(q.pack(size) + b"\x00" * 32)   # bad digest

    t = threading.Thread(target=fake_receiver)
    t.start()
    ready.wait(10)
    with pytest.raises(IOError, match="acked sha256"):
        send_file(str(src), "127.0.0.1", port, retries=0)
    t.join(timeout=10)


def _cfg(ckpt, **kw):
    return TrainConfig(**dict(dict(
        model="bnn-mlp-small", model_kwargs={"infl_ratio": 1}, epochs=1,
        batch_size=32, backend="xla", seed=1, device="cpu",
        checkpoint_dir=str(ckpt)), **kw))


def test_ship_checkpoint_and_resume_elsewhere(tmp_path):
    """The node trains and ships its latest checkpoint and meta; the
    master receives them into its own directory, restores the same
    state, and resumes the run there bitwise."""
    data = load_mnist("/nonexistent", synthetic_sizes=(128, 64))
    node_dir, master_dir = tmp_path / "node_ck", tmp_path / "master_ck"
    t1 = Trainer(_cfg(node_dir))
    t1.fit(data)
    port = _free_port()
    th, result = _receive_in_thread(receive_checkpoint, str(master_dir),
                                    port)
    ship_checkpoint(str(node_dir), "127.0.0.1", port)
    th.join(timeout=10)
    assert result["out"] == str(master_dir / ck.LATEST)
    port = _free_port()
    th, _ = _receive_in_thread(receive_file, str(master_dir), port)
    send_file(str(node_dir / ck.META), "127.0.0.1", port)
    th.join(timeout=10)
    assert ck.verify_checkpoint(str(master_dir))
    t2 = Trainer(_cfg(master_dir))
    t2.restore(str(master_dir))
    a, b = util._full_state(t1), util._full_state(t2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    whole = Trainer(_cfg(tmp_path / "whole", epochs=2))
    whole.fit(data)
    resumed = Trainer(_cfg(master_dir, epochs=2, resume=True))
    assert [h["epoch"] for h in resumed.fit(data)] == [1]
    a, b = util._full_state(whole), util._full_state(resumed)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_send_file_connect_retry_then_clear_error(tmp_path):
    src = tmp_path / "a.bin"
    src.write_bytes(b"x" * 128)
    port = _free_port()   # nothing listens there
    before = transfer.connect_retries
    with pytest.raises(ConnectionError) as ei:
        send_file(str(src), "127.0.0.1", port, timeout=0.5, retries=1,
                  backoff_s=0.0)
    assert str(port) in str(ei.value) and "2 attempts" in str(ei.value)
    assert transfer.connect_retries == before + 1


def test_receive_file_timeout_names_the_port(tmp_path):
    port = _free_port()
    with pytest.raises(TimeoutError) as ei:
        receive_file(str(tmp_path), port, timeout=0.2)
    assert str(port) in str(ei.value)
    assert not os.listdir(tmp_path)
