"""Process helpers for a world of train processes (the port of
``contrad_tpu/hostenv.py``): the rendezvous variables, a free port, a
worker's environment and :func:`spawn_world`, which launches every process
of a world and waits for them together.

A world is one process per card. ``torchrun --nproc_per_node=N -m
contrad_tpu_torch.train_gan ... --multihost`` launches one; so does
:func:`spawn_world` with the ``CONTRAD_*`` variables set per process (the
port's ``parallel/_mh_worker.py`` and the tests do that), which is how a
world runs on the CPU with gloo.
"""

from __future__ import annotations

import os
import socket
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

# Rendezvous variables read by ``parallel/mesh.py::init_distributed``, the
# port's own and torchrun's; a spawned worker must never inherit them from an
# outer world.
RENDEZVOUS_VARS = ("CONTRAD_COORDINATOR", "CONTRAD_NUM_PROCESSES",
                   "CONTRAD_PROCESS_ID", "CONTRAD_LOCAL_RANK",
                   "CONTRAD_BACKEND", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                   "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    """An OS-assigned free localhost port (for the rendezvous store)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(repo: str) -> Dict[str, str]:
    """Environment for a spawned world process: the repo importable and any
    outer rendezvous state scrubbed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    for k in RENDEZVOUS_VARS:
        env.pop(k, None)
    return env


def rank_env(env: Dict[str, str], port: int, rank: int, world: int,
             backend: str = "") -> Dict[str, str]:
    """``env`` with the ``CONTRAD_*`` rendezvous of process ``rank`` of a
    ``world``-process world on ``127.0.0.1:port``; ``backend`` (``gloo`` or
    ``nccl``) overrides the device's default."""
    env = dict(env, CONTRAD_COORDINATOR=f"127.0.0.1:{port}",
               CONTRAD_NUM_PROCESSES=str(world), CONTRAD_PROCESS_ID=str(rank))
    if backend:
        env["CONTRAD_BACKEND"] = backend
    return env


def spawn_world(cmds_envs: Sequence[Tuple[List[str], Dict[str, str]]],
                cwd: str, timeout: float = 900) -> List[str]:
    """Launch one process per ``(cmd, env)``, wait for all, kill stragglers.

    All processes are launched before any is waited on (they must rendezvous
    with each other), and all pipes are drained concurrently: a rank that
    writes more than a pipe holds before its next collective must not block
    while another rank is being waited on, or the world deadlocks until the
    timeout. ``timeout`` is one deadline for the whole world; a process
    that exits non-zero ends the others at once. Raises ``RuntimeError``
    with the failing process's output tail if any exits non-zero (or is
    ended); returns each process's output (stdout and stderr) otherwise.
    The JAX package relaunches a world that its XLA gloo contexts starved;
    torch's gloo takes its rendezvous once, at ``init_process_group``, with
    a timeout of its own, so there is no such retry here."""
    procs = [subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in cmds_envs]
    outs: List[str] = [""] * len(procs)

    def _drain(i: int, p: subprocess.Popen) -> None:
        outs[i] = p.stdout.read()

    readers = [threading.Thread(target=_drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + timeout
    try:
        # a rank that fails ends the world: the others would wait in their
        # next collective until its timeout
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in readers:  # EOF arrives once the process is dead
            t.join(timeout=30)
    failed = [(p, out) for p, out in zip(procs, outs) if p.returncode != 0]
    if failed:  # the rank that failed first, before those ended for it
        p, out = min(failed, key=lambda f: f[0].returncode < 0)
        raise RuntimeError(
            f"worker rc={p.returncode}\n--- output tail ---\n{out[-4000:]}")
    return outs
