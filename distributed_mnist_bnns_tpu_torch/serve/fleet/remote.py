"""Remote replicas: a host agent + Popen-shaped process handles.

The :class:`~.supervisor.ReplicaSupervisor` supervises *processes* —
spawn, poll, signal, reap. Nothing in that loop actually needs the
process to be local: this module supplies the two halves that let the
same supervisor (and the same router health probes, breakers and
respawn backoff — unchanged) drive replicas on ANOTHER machine:

  :class:`HostAgent`
      a minimal control server that runs on the replica host: one
      JSON-line request per TCP connection (``spawn`` / ``poll`` /
      ``signal`` / ``free_port`` / ``ensure_artifact``), children
      tracked by pid. Artifacts are staged over the digest-verified
      :mod:`utils.transfer` framed protocol — the agent hands back a
      one-shot receive port, the client ships with ``send_file``, and
      the stored name embeds the sha256 so a respawn at the same digest
      never re-ships (the replica spec of SERVING.md "Remote fleet":
      host:port + artifact digest).

  :class:`RemoteLauncher` / :class:`RemoteProcess`
      the supervisor-side counterpart: ``launch`` returns a handle with
      the ``subprocess.Popen`` surface the supervisor already uses
      (``poll``/``wait``/``send_signal``/``kill``/``pid``), each call a
      one-line RPC. ``ensure_artifact`` stages the local artifact and
      returns its remote path for ``spawn_command``.

The agent trusts its network — it executes what it is told, exactly
like ``sshd`` with a fixed command would. Bind it to loopback or a
private interconnect; it is a fleet-internal control plane, not a
public endpoint. No module here imports torch (fleet rule: replicas do
the inference, the control plane stays light).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import signal as _signal
import socket
import subprocess
import threading
import time
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)

_MAX_LINE = 1 << 20  # a request is one JSON line; 1 MiB is generous


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _recv_line(conn: socket.socket) -> bytes:
    buf = bytearray()
    while not buf.endswith(b"\n"):
        if len(buf) > _MAX_LINE:
            raise IOError("request line too long")
        chunk = conn.recv(4096)
        if not chunk:
            break
        buf.extend(chunk)
    return bytes(buf)


class HostAgent:
    """The replica-host side: serve one JSON-line request per
    connection, keep the children it spawned, stage shipped artifacts
    under ``workdir/artifacts``. ``start()`` binds (port 0 picks a free
    one — read ``.port`` after), ``close()`` stops the accept loop and
    SIGKILLs any children still alive (an agent teardown must not leak
    orphan replicas)."""

    def __init__(self, workdir: str, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.workdir = workdir
        self.host = host
        self.port = port
        self._srv: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._children: Dict[int, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._closing = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "HostAgent":
        os.makedirs(os.path.join(self.workdir, "artifacts"), exist_ok=True)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port))
        srv.listen(16)
        # closing the fd does not wake a thread parked in accept() on
        # Linux — poll so close() returns promptly
        srv.settimeout(0.2)
        self.port = srv.getsockname()[1]
        self._srv = srv
        self._thread = threading.Thread(
            target=self._serve, name="fleet-host-agent", daemon=True
        )
        self._thread.start()
        log.info("host agent serving on %s:%d (workdir %s)",
                 self.host, self.port, self.workdir)
        return self

    def close(self) -> None:
        self._closing = True
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            children = list(self._children.values())
        for proc in children:
            if proc.poll() is None:
                try:
                    proc.kill()
                except OSError:
                    pass
                proc.wait()

    # -- serving -------------------------------------------------------------

    def _serve(self) -> None:
        assert self._srv is not None
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # closed
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            ).start()

    def _handle(self, conn: socket.socket) -> None:
        with conn:
            conn.settimeout(30.0)
            try:
                req = json.loads(_recv_line(conn).decode() or "{}")
                resp = self._dispatch(req)
            except Exception as e:  # a bad request must not kill the agent
                log.warning("host agent request failed: %s", e)
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            try:
                conn.sendall(json.dumps(resp).encode() + b"\n")
            except OSError:
                pass

    def _dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        if op == "spawn":
            return self._op_spawn(req)
        if op == "poll":
            return self._op_poll(req)
        if op == "signal":
            return self._op_signal(req)
        if op == "free_port":
            with socket.socket() as s:
                s.bind((self.host, 0))
                return {"ok": True, "port": s.getsockname()[1]}
        if op == "ensure_artifact":
            return self._op_ensure_artifact(req)
        if op == "ping":
            return {"ok": True, "pid": os.getpid()}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _op_spawn(self, req: Dict[str, Any]) -> Dict[str, Any]:
        cmd = req["cmd"]
        env = dict(os.environ)
        env.update(req.get("env") or {})
        proc = subprocess.Popen(
            [str(c) for c in cmd], env=env, cwd=self.workdir
        )
        with self._lock:
            self._children[proc.pid] = proc
        log.info("host agent spawned pid %d: %s", proc.pid, cmd)
        return {"ok": True, "pid": proc.pid}

    def _op_poll(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            proc = self._children.get(int(req["pid"]))
        if proc is None:
            return {"ok": False, "error": f"unknown pid {req.get('pid')}"}
        return {"ok": True, "rc": proc.poll()}

    def _op_signal(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            proc = self._children.get(int(req["pid"]))
        if proc is None:
            return {"ok": False, "error": f"unknown pid {req.get('pid')}"}
        try:
            proc.send_signal(int(req.get("signum") or _signal.SIGTERM))
        except OSError as e:
            return {"ok": False, "error": str(e)}
        return {"ok": True}

    def _op_ensure_artifact(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Stage-by-digest: the stored name embeds the sha256, so the
        common respawn/rollback case (same digest) answers from disk
        with zero bytes shipped. A miss hands back a one-shot
        :func:`utils.transfer.receive_file` port; the framed protocol
        verifies the digest before the atomic rename, and we re-check
        it against the digest the CLIENT promised (a sender shipping
        the wrong-but-intact file is rejected here)."""
        name = os.path.basename(str(req["name"]))
        sha = str(req["sha256"])
        dest = os.path.join(
            self.workdir, "artifacts", f"{sha[:16]}-{name}"
        )
        if os.path.exists(dest):
            return {"ok": True, "path": dest, "shipped": False}
        if req.get("probe"):
            # A staging poll: report not-yet-there without opening
            # another one-shot receive port.
            return {"ok": True, "path": dest, "shipped": True}
        with socket.socket() as s:
            s.bind((self.host, 0))
            port = s.getsockname()[1]

        result: Dict[str, Any] = {}

        def _receive() -> None:
            from ...utils.transfer import receive_file

            try:
                result["path"], _ = receive_file(
                    os.path.join(self.workdir, "artifacts"), port,
                    host=self.host, timeout=120.0,
                )
            except Exception as e:
                result["error"] = f"{type(e).__name__}: {e}"

        t = threading.Thread(target=_receive, daemon=True)
        t.start()
        # The client ships on seeing this response; finalize in a
        # follow-up thread so the one-line RPC can return now.

        def _finalize() -> None:
            t.join(timeout=130.0)
            path = result.get("path")
            if not path:
                log.warning("artifact ship to port %d failed: %s",
                            port, result.get("error", "timeout"))
                return
            if _digest(path) != sha:
                log.warning(
                    "shipped artifact digest mismatch (want %s…); "
                    "discarding", sha[:16],
                )
                os.remove(path)
                return
            os.replace(path, dest)
            log.info("staged artifact %s", dest)

        threading.Thread(target=_finalize, daemon=True).start()
        return {"ok": True, "path": dest, "shipped": True, "port": port}


class RemoteProcess:
    """A ``subprocess.Popen``-shaped handle for an agent-spawned
    process — exactly the surface the supervisor's reap/retire/drain
    paths use. An agent that became unreachable reads as exit
    ``-SIGKILL``: the host is gone, and the supervisor's host-loss
    handling (respawn with backoff) is precisely the right response."""

    def __init__(self, launcher: "RemoteLauncher", pid: int):
        self._launcher = launcher
        self.pid = pid
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        try:
            resp = self._launcher._rpc({"op": "poll", "pid": self.pid})
        except (OSError, ValueError):
            self.returncode = -int(_signal.SIGKILL)
            return self.returncode
        if not resp.get("ok"):
            self.returncode = -int(_signal.SIGKILL)
        elif resp.get("rc") is not None:
            self.returncode = int(resp["rc"])
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(
                    f"remote pid {self.pid}", timeout
                )
            time.sleep(0.05)
        return self.returncode  # type: ignore[return-value]

    def send_signal(self, signum: int) -> None:
        if self.returncode is not None:
            return
        try:
            self._launcher._rpc(
                {"op": "signal", "pid": self.pid, "signum": int(signum)}
            )
        except (OSError, ValueError):
            pass  # same contract as Popen.send_signal on a dead child

    def terminate(self) -> None:
        self.send_signal(int(_signal.SIGTERM))

    def kill(self) -> None:
        self.send_signal(int(_signal.SIGKILL))


class RemoteLauncher:
    """The supervisor-side client of one :class:`HostAgent` — pass as
    ``ReplicaSupervisor(..., launcher=...)`` to place that fleet's
    replicas on the agent's host. ``host`` is where spawned replicas
    are reachable (the router's transport URLs are built from it)."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 10.0):
        self.host = host
        self.port = port
        self.timeout_s = float(timeout_s)
        self._digests: Dict[str, str] = {}   # local path -> sha256
        self._staged: Dict[str, str] = {}    # sha256 -> remote path

    def _rpc(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        ) as s:
            s.sendall(json.dumps(req).encode() + b"\n")
            s.shutdown(socket.SHUT_WR)
            buf = bytearray()
            while not buf.endswith(b"\n"):
                chunk = s.recv(4096)
                if not chunk:
                    break
                buf.extend(chunk)
        return json.loads(buf.decode() or "{}")

    def ping(self) -> bool:
        try:
            return bool(self._rpc({"op": "ping"}).get("ok"))
        except (OSError, ValueError):
            return False

    def free_port(self) -> int:
        resp = self._rpc({"op": "free_port"})
        if not resp.get("ok"):
            raise IOError(f"agent free_port failed: {resp.get('error')}")
        return int(resp["port"])

    def launch(self, cmd: List[str],
               env: Optional[Dict[str, str]] = None) -> RemoteProcess:
        resp = self._rpc({"op": "spawn", "cmd": list(cmd),
                          "env": dict(env or {})})
        if not resp.get("ok"):
            raise IOError(f"agent spawn failed: {resp.get('error')}")
        return RemoteProcess(self, int(resp["pid"]))

    def ensure_artifact(self, path: str) -> str:
        """The local artifact's path ON THE AGENT HOST, shipping it
        (utils/transfer, digest-verified) only if that digest is not
        already staged there. Respawns and rollbacks re-resolve through
        here, so they are zero-copy at an unchanged digest."""
        sha = self._digests.get(path)
        if sha is None:
            sha = self._digests[path] = _digest(path)
        cached = self._staged.get(sha)
        if cached is not None:
            return cached
        resp = self._rpc({
            "op": "ensure_artifact",
            "name": os.path.basename(path), "sha256": sha,
        })
        if not resp.get("ok"):
            raise IOError(
                f"agent ensure_artifact failed: {resp.get('error')}"
            )
        if resp.get("shipped"):
            from ...utils.transfer import send_file

            send_file(path, self.host, int(resp["port"]))
            # The agent finalizes (digest re-check + atomic rename) off
            # the RPC path; re-ask until it answers from disk so a
            # spawn_command never names an artifact that is not staged
            # yet.
            deadline = time.monotonic() + 30.0
            while True:
                check = self._rpc({
                    "op": "ensure_artifact", "probe": True,
                    "name": os.path.basename(path), "sha256": sha,
                })
                if check.get("ok") and not check.get("shipped"):
                    break
                if time.monotonic() > deadline:
                    raise IOError(
                        f"artifact {path} shipped but never staged "
                        f"(digest {sha[:16]}…)"
                    )
                time.sleep(0.05)
        self._staged[sha] = str(resp["path"])
        return self._staged[sha]
