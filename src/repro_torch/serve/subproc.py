"""Spawn a ``repro_torch.serve.server`` subprocess and parse its banner.

One copy of the PYTHONPATH plumbing, ``[serve] listening on http://...``
banner parsing, dead-server diagnostics, and kill-the-whole-session
teardown — shared by ``benchmarks/serve_bench.py``,
``examples/serve_predictions.py``, and the end-to-end tests, which had
each grown a slightly different (and slightly wrong) copy.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Sequence, Tuple


def start_server_subprocess(
        extra_args: Sequence[str] = (),
        binary: bool = False):
    """Launch ``python -m repro_torch.serve.server --port 0`` in its own session
    and return ``(proc, host, port)`` once the listening banner arrives —
    or ``(proc, host, port, binary_port)`` when ``binary=True``, which
    adds ``--binary-port 0`` and parses the second
    ``[serve] binary on host:port`` banner line.

    A server that dies at import/bind time is reaped and surfaced as a
    ``RuntimeError`` carrying its exit status, not an ``IndexError`` on
    the missing banner.
    """
    env = dict(os.environ)
    src = os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    args = [sys.executable, "-m", "repro_torch.serve.server", "--port", "0"]
    if binary and "--binary-port" not in extra_args:
        args += ["--binary-port", "0"]
    proc = subprocess.Popen(
        [*args, *extra_args],
        stdout=subprocess.PIPE, text=True, env=env,
        start_new_session=True)
    line = proc.stdout.readline()
    if "http://" not in line:
        stop_server_subprocess(proc)
        raise RuntimeError(
            f"server failed to start (exit {proc.poll()}): {line!r}")
    addr = line.rsplit("http://", 1)[1].strip()
    host, port = addr.rsplit(":", 1)
    if not binary:
        return proc, host, int(port)
    line = proc.stdout.readline()
    if "binary on" not in line:
        stop_server_subprocess(proc)
        raise RuntimeError(
            f"server printed no binary banner (exit {proc.poll()}): "
            f"{line!r}")
    _, bport = line.rsplit("binary on ", 1)[1].strip().rsplit(":", 1)
    return proc, host, int(port), int(bport)


def stop_server_subprocess(proc: subprocess.Popen) -> None:
    """SIGTERM (the server's handler reaps its worker pool), then kill the
    whole session as a fallback so a wedged pool child can never outlive
    the caller."""
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        pass
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        pass
