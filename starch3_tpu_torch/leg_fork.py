"""Start the legs of ``starch3_tpu_torch.scale_run`` without paying for
``import torch`` in each: a fork server, one process that imports torch,
NumPy and the modules the legs use once and forks each leg from itself.

    python -m starch3_tpu_torch.leg_fork        (the server; ``LegForker`` starts it)

A forked leg keeps what a process of its own gives it: a session and
process group of its own (killed whole when it fails or outlives its
limit), its own CUDA context, its own memory readings and its own
standard output and error, written to files its caller names.  The
server never initialises CUDA, since a forked child cannot use a context
made in its parent: it refuses to fork once ``torch.cuda.is_initialized()``
(``fork_leg``).  Nor does it fork beside a thread of its own: it refuses
while a Python thread other than its main one runs, or while it holds
more threads than its imports left it (``threads`` in its first reply).
Those are NumPy's OpenBLAS pool, which OpenBLAS stops before each fork
(its own ``pthread_atfork`` handler) and a child starts again at its
first BLAS call; after the first fork the server runs on one thread.
``spawn`` starts a leg as a fresh process instead, as a user's command
starts.

The protocol is one JSON object a line.  The caller writes ``{"id",
"args", "env", "stdout", "stderr"}`` to the server's standard input; the
server answers ``{"ready", "import_s", "threads"}`` once, after its
imports, then ``{"id", "pid"}`` (or ``{"id", "error"}``) for each request
and ``{"id", "exit"}`` when that leg has ended.  At the end of its input
it kills the process group of every leg still running.
"""

from __future__ import annotations

import importlib
import io
import itertools
import json
import os
import queue
import select
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import typing

# what a leg imports before its work (``scale_run.main``); the server
# imports the same modules, and ``scale_run`` itself, before it forks
LEG_MODULES = (
    "torch",
    "starch3_tpu_torch.api",
    "starch3_tpu_torch.cli",
    "starch3_tpu_torch.observability",
    "starch3_tpu_torch.ops.mtf_narrow",
    "starch3_tpu_torch.ops.mtf_wide",
    "starch3_tpu_torch.parallel.distributed",
    "starch3_tpu_torch.parallel.pipeline",
)
# and what a traced leg imports later: ``torch.profiler``'s first start in
# a process imports ``torch._inductor`` (9-14 s on an H100's host, in every
# traced device-only leg), which the server imports once instead
FORK_ONLY_MODULES = ("starch3_tpu_torch.scale_run", "torch._inductor")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READY_S = 300.0  # the server's imports took 10 s on an H100's host


class LegTimeout(Exception):
    """A leg still running at its limit; its process group has been killed."""


class LegResult(typing.NamedTuple):
    returncode: int
    stdout: bytes
    stderr: bytes
    launched_at: float  # time.time() when the leg was asked for


def leg_times(res: dict, launched_at: float) -> dict:
    """A leg's start (from the request to the end of its imports: exec, the
    interpreter and imports for a fresh process, the fork for a forked one),
    CUDA initialisation and work seconds, from its JSON line's ``timing``."""
    t = res["timing"]
    return {"start_s": t["main_at"] - launched_at + t["imports_s"], "cuda_init_s": t["cuda_init_s"],
            "work_s": t["work_s"]}


def _kill_group(pid: int) -> None:
    try:
        os.killpg(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def spawn(args, timeout_s: float, env=None, root: str = ROOT) -> LegResult:
    """``python -m starch3_tpu_torch.scale_run ARGS`` as a fresh process in
    a session of its own, killed with everything it started when it is
    still running after ``timeout_s``."""
    launched = time.time()
    proc = subprocess.Popen([sys.executable, "-m", "starch3_tpu_torch.scale_run", *map(str, args)], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, start_new_session=True,
                            env=dict(os.environ, **(env or {})))
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        raise LegTimeout(f"still running after {timeout_s:.0f} s") from None
    finally:
        if proc.poll() is None:
            _kill_group(proc.pid)
            proc.wait()
    return LegResult(proc.returncode, out, err, launched)


# ---------------------------------------------------------------- server


def _send(fd: int, obj: dict) -> None:
    data = (json.dumps(obj) + "\n").encode()
    while data:
        data = data[os.write(fd, data):]


def _run_leg(req: dict, reply_fd: int) -> typing.NoReturn:
    """The forked child: a session of its own, the caller's environment and
    output files, then ``scale_run.main``; it never returns."""
    code = 1
    try:
        os.setsid()
        os.close(reply_fd)
        null = os.open(os.devnull, os.O_RDONLY)
        os.dup2(null, 0)
        os.close(null)
        for fd, path in ((1, req["stdout"]), (2, req["stderr"])):
            f = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            os.dup2(f, fd)
            os.close(f)
        # file objects of its own on the new descriptors
        sys.stdin = open(0, closefd=False)
        sys.stdout = io.TextIOWrapper(io.FileIO(1, "w", closefd=False), write_through=True)
        sys.stderr = io.TextIOWrapper(io.FileIO(2, "w", closefd=False), write_through=True)
        os.environ.update(req.get("env") or {})
        from starch3_tpu_torch import scale_run

        code = scale_run.main(req["args"])
    except SystemExit as e:
        if isinstance(e.code, int) or e.code is None:
            code = e.code or 0
        else:  # as the interpreter does with a message
            print(e.code, file=sys.stderr)
            code = 1
    except BaseException:
        traceback.print_exc()
        code = 1
    finally:
        for f in (sys.stdout, sys.stderr):
            try:
                f.flush()
            except Exception:
                pass
        os._exit(code)


def thread_count() -> int:
    """The threads of this process, native ones included."""
    return len(os.listdir("/proc/self/task"))


def fork_leg(req: dict, reply_fd: int, max_threads: int) -> int:
    """Fork one leg and return its pid.  Refuses, before forking, when CUDA
    is initialised in this process (the child could not use the card), or
    when a thread runs that the child would not have: a Python thread
    besides the main one, or more than ``max_threads`` in all."""
    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError("CUDA is initialised in the fork server: a forked leg could not use the card")
    n, py = thread_count(), threading.active_count()
    if py != 1 or n > max_threads:
        raise RuntimeError(f"the fork server runs {n} threads ({py} of Python), its imports left {max_threads}: "
                           "a forked leg would lose what they hold")
    pid = os.fork()
    if pid == 0:
        _run_leg(req, reply_fd)
    return pid


def serve() -> int:
    """The server's loop, on one thread: it reads requests and reaps the
    legs that ended, and starts no thread (``fork_leg`` checks)."""
    t0 = time.perf_counter()
    for name in (*LEG_MODULES, *FORK_ONLY_MODULES):
        importlib.import_module(name)
    reply_fd = os.dup(1)
    os.dup2(2, 1)  # anything else printed goes to standard error
    live: dict[int, int] = {}  # pid -> request id
    imported = thread_count()
    _send(reply_fd, {"ready": True, "import_s": time.perf_counter() - t0, "threads": imported})
    buf = b""
    try:
        while True:
            if select.select([0], [], [], 0.05)[0]:
                chunk = os.read(0, 1 << 16)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    req = json.loads(line)
                    try:
                        pid = fork_leg(req, reply_fd, imported)
                    except RuntimeError as e:  # the caller fails the leg
                        _send(reply_fd, {"id": req["id"], "error": str(e)})
                        continue
                    live[pid] = req["id"]
                    _send(reply_fd, {"id": req["id"], "pid": pid})
            while live:
                pid, status = os.waitpid(-1, os.WNOHANG)
                if pid == 0:
                    break
                _send(reply_fd, {"id": live.pop(pid), "exit": os.waitstatus_to_exitcode(status)})
    finally:
        for pid in live:
            _kill_group(pid)
    return 0


# ---------------------------------------------------------------- client


class LegForker:
    """The caller's side: starts the server (which imports while the
    caller goes on), then ``run`` forks a leg and waits for it.  Safe to
    call from several threads.  ``close`` ends the server, which kills any
    leg still running."""

    def __init__(self, root: str = ROOT):
        self.proc = subprocess.Popen([sys.executable, "-m", "starch3_tpu_torch.leg_fork"], cwd=root,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, start_new_session=True)
        self._lock = threading.Lock()
        self._ready_lock = threading.Lock()  # one waiter takes the server's one "ready" line
        self._queues: dict = {}
        self._ids = itertools.count()
        self._dir = tempfile.TemporaryDirectory(prefix="s3t-legs-")
        self.ready = None
        self._reader = threading.Thread(target=self._read, name="leg-fork-reader", daemon=True)
        self._reader.start()

    def _queue(self, key) -> queue.Queue:
        with self._lock:
            return self._queues.setdefault(key, queue.Queue())

    def _read(self) -> None:
        for line in self.proc.stdout:
            msg = json.loads(line)
            self._queue(msg.get("id", "ready")).put(msg)
        with self._lock:  # the server is gone: wake every waiter
            for q in self._queues.values():
                q.put({"gone": True})

    def _get(self, q: queue.Queue, timeout_s: float) -> dict:
        msg = q.get(timeout=max(timeout_s, 0.0))
        if msg.get("gone"):
            q.put(msg)
            raise RuntimeError(f"the fork server ended (exit {self.proc.poll()})")
        return msg

    def wait_ready(self) -> dict:
        with self._ready_lock:
            if self.ready is None:
                try:
                    self.ready = self._get(self._queue("ready"), READY_S)
                except queue.Empty:
                    raise RuntimeError(f"the fork server was not ready after {READY_S:.0f} s") from None
        return self.ready

    def run(self, args, timeout_s: float, env=None) -> LegResult:
        """Fork ``scale_run.main(ARGS)`` with ``env`` added to its
        environment; raise ``LegTimeout`` after killing its process group
        if it is still running after ``timeout_s``."""
        self.wait_ready()
        rid = next(self._ids)
        q = self._queue(rid)
        out, err = (os.path.join(self._dir.name, f"{rid}.{s}") for s in ("out", "err"))
        req = {"id": rid, "args": [str(a) for a in args], "env": env or {}, "stdout": out, "stderr": err}
        launched = time.time()
        deadline = time.monotonic() + timeout_s
        with self._lock:
            self.proc.stdin.write((json.dumps(req) + "\n").encode())
            self.proc.stdin.flush()
        try:
            msg = self._get(q, deadline - time.monotonic())
        except queue.Empty:
            raise LegTimeout(f"not forked within {timeout_s:.0f} s") from None
        if "error" in msg:
            raise RuntimeError(f"the fork server refused the leg: {msg['error']}")
        pid = msg["pid"]
        try:
            msg = self._get(q, deadline - time.monotonic())
        except queue.Empty:
            _kill_group(pid)
            try:
                self._get(q, 60)  # its exit, once the server has reaped it
            except queue.Empty:
                pass
            raise LegTimeout(f"still running after {timeout_s:.0f} s") from None
        finally:
            _kill_group(pid)  # whatever it started and left behind
        with self._lock:
            del self._queues[rid]
        with open(out, "rb") as fo, open(err, "rb") as fe:
            res = LegResult(msg["exit"], fo.read(), fe.read(), launched)
        os.remove(out)
        os.remove(err)
        return res

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                _kill_group(self.proc.pid)
                self.proc.wait()
        self._reader.join(timeout=10)
        self.proc.stdout.close()
        self._dir.cleanup()

    def __enter__(self) -> "LegForker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


if __name__ == "__main__":
    sys.exit(serve())
