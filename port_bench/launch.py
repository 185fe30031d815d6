"""One process a card for a cell across cards: start the ranks, wait for
them under a deadline, and stop every one of them on the first failure,
at the deadline, or when this process gets SIGTERM.

Each rank gets torch's ``env://`` variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), and runs in a session
of its own, so that stopping it also stops what it started. Rank 0's
standard output comes back to the caller; every rank's standard error,
and the standard output of the others, go to this process's standard
error.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import threading
import time

MASTER_ADDR = "127.0.0.1"
POLL_S = 0.05
STDERR_FD = 2  # the other ranks' standard output goes to this process's standard error
STOP_GRACE_S = 5.0  # after SIGTERM, before SIGKILL


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((MASTER_ADDR, 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR=MASTER_ADDR, MASTER_PORT=str(port))
    return env


def _stop(procs) -> None:
    """SIGTERM to each rank's session, SIGKILL to what is left after the
    grace, and wait for every rank."""
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, sig)
                except ProcessLookupError:
                    pass
        end = time.monotonic() + STOP_GRACE_S
        while any(p.poll() is None for p in procs) and time.monotonic() < end:
            time.sleep(POLL_S)
    for p in procs:
        p.wait()


def run_ranks(command_of, world: int, deadline_s: float, log, cwd=None):
    """Run ``command_of(rank)`` (an argument list) for each rank of
    ``world``; returns (exit code, rank 0's standard output). The code is
    0 when every rank exits 0; else the first failing rank's code (1 for a
    rank ended by a signal), or 124 when the deadline (seconds from now)
    passed first. Every rank has ended when this returns, also where
    this process is ended by SIGTERM (then SystemExit 143)."""

    def ended(signum, frame):
        raise SystemExit(128 + signum)

    port = free_port()
    procs, out = [], []
    previous = signal.signal(signal.SIGTERM, ended)
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                command_of(rank), cwd=cwd, env=rank_env(rank, world, port),
                stdout=subprocess.PIPE if rank == 0 else STDERR_FD, stdin=subprocess.DEVNULL,
                start_new_session=True, text=rank == 0))
        reader = threading.Thread(target=lambda: out.append(procs[0].stdout.read()), daemon=True)
        reader.start()
        end = time.monotonic() + deadline_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                rank, code = failed[0]
                log(f"rank {rank} exited with {code}: stopping every rank")
                return (code if code > 0 else 1), ""
            if all(c == 0 for c in codes):
                reader.join()
                return 0, "".join(out)
            if time.monotonic() > end:
                log(f"ranks still running {deadline_s:.0f} s after their start: stopping them")
                return 124, ""
            time.sleep(POLL_S)
    finally:
        _stop(procs)
        signal.signal(signal.SIGTERM, previous)
