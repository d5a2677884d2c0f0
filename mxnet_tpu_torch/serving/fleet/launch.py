"""Spawn and supervise fleet worker subprocesses.

Counterpart of mxnet_tpu/serving/fleet/launch.py. `spawn_worker`
launches `python -m mxnet_tpu_torch.serving.fleet.worker` with a JSON
spec written to a temporary file, waits (at most `ready_timeout_s`) for
the worker's `FLEET_WORKER_READY {json}` line (model build and warmup
included: ready means every kernel library its traffic needs is
loaded), and returns a `WorkerProc` handle that can kill (SIGKILL, the
chaos tests' murder weapon), terminate and reap the process.
`spawn_fleet` brings up a whole topology and tears it down as a context
manager. The worker runs where its spec's "device" (or `device=` here)
says, on the CUDA card by default.
"""
from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
import time

from ...base import MXNetError

__all__ = ["WorkerProc", "spawn_worker", "spawn_fleet", "FleetProcs",
           "WORKER_MODULE"]

#: The module a worker process runs (`python -m`).
WORKER_MODULE = "mxnet_tpu_torch.serving.fleet.worker"

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))


class WorkerProc:
    """One spawned worker subprocess and its READY announcement."""

    def __init__(self, proc, url, role, worker_id, spec_path, tail):
        self.proc = proc
        self.url = url
        self.role = role
        self.worker_id = worker_id
        self.pid = proc.pid
        self.output_tail = tail
        self._spec_path = spec_path

    @property
    def alive(self):
        return self.proc.poll() is None

    def kill(self):
        """SIGKILL: no goodbye, no flushing; the router must notice by
        the connection loss, exactly like a machine loss."""
        if self.alive:
            try:
                self.proc.kill()
            except OSError:
                pass
        self.wait(10)

    def terminate(self):
        if self.alive:
            try:
                self.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass

    def wait(self, timeout=30):
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        _unlink(self._spec_path)

    def __repr__(self):
        return (f"WorkerProc(pid={self.pid}, url={self.url}, "
                f"role={self.role}, alive={self.alive})")


def _unlink(path):
    try:
        os.unlink(path)
    except OSError:
        pass


def _pump_output(proc, lines, tail):
    """Read the child's combined stdout/stderr for its whole life, so
    the pipe never fills and blocks it: each line goes to `lines` (the
    READY wait reads it with a timeout) and to a bounded `tail` for
    post-mortems. None on `lines` marks EOF."""
    def run():
        for line in proc.stdout:
            line = line.rstrip("\n")
            tail.append(line)
            del tail[:-200]
            lines.put(line)
        lines.put(None)
    threading.Thread(target=run, daemon=True,
                     name=f"mx-fleet-output:{proc.pid}").start()


def spawn_worker(spec, role="mixed", host="127.0.0.1", port=0,
                 ship_payload=True, warmup=True, env=None,
                 ready_timeout_s=600.0, device=None):
    """Launch one worker process and block until it is READY, dead, or
    `ready_timeout_s` has passed (then it is killed). Returns a
    WorkerProc. The spec travels in a temporary file, so big engine
    configs never hit argv limits."""
    fd, spec_path = tempfile.mkstemp(prefix="mx_fleet_spec_",
                                     suffix=".json")
    with os.fdopen(fd, "w", encoding="utf-8") as f:
        json.dump(spec, f)
    cmd = [sys.executable, "-m", WORKER_MODULE,
           "--spec", spec_path, "--role", role,
           "--host", host, "--port", str(port)]
    if device is not None:
        cmd += ["--device", str(device)]
    if not ship_payload:
        cmd.append("--no-ship-payload")
    if not warmup:
        cmd.append("--no-warmup")
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = _REPO_ROOT + os.pathsep \
        + child_env.get("PYTHONPATH", "")
    child_env.update(env or {})
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=_REPO_ROOT, env=child_env)
    lines, tail = queue.Queue(), []
    _pump_output(proc, lines, tail)
    deadline = time.monotonic() + float(ready_timeout_s)
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        try:
            line = lines.get(timeout=min(left, 1.0))
        except queue.Empty:
            continue
        if line is None:
            proc.wait(10)
            _unlink(spec_path)
            raise MXNetError(
                "fleet worker died before READY (rc="
                f"{proc.returncode}):\n" + "\n".join(tail[-40:]))
        if line.startswith("FLEET_WORKER_READY "):
            info = json.loads(line[len("FLEET_WORKER_READY "):])
            return WorkerProc(proc, info["url"], info.get("role", role),
                              info.get("worker_id"), spec_path, tail)
    proc.kill()
    proc.wait(10)
    _unlink(spec_path)
    raise MXNetError(
        f"fleet worker not READY within {ready_timeout_s}s:\n"
        + "\n".join(tail[-40:]))


class FleetProcs:
    """A spawned topology: `workers` in spawn order. Context manager;
    close() SIGKILLs and reaps every worker still alive."""

    def __init__(self, workers):
        self.workers = list(workers)

    @property
    def urls(self):
        return [w.url for w in self.workers]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        for w in self.workers:
            w.kill()


def spawn_fleet(spec, roles=("mixed", "mixed"), **kw):
    """Bring up one worker per role entry, one after another (a model
    build is memory-hungry enough that parallel cold starts thrash small
    hosts). Returns a FleetProcs; a worker that fails to come up takes
    the ones already started down with it."""
    procs = []
    try:
        for role in roles:
            procs.append(spawn_worker(spec, role=role, **kw))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return FleetProcs(procs)
