"""Launcher: N ranks of a script or a module on one node, torn down together.

Port of ``antmmf_tpu/utils/launch.py``: ``launch`` starts one process a
rank with the ``torch.distributed`` environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``) that ``parallel.collectives.init_distributed``
reads, and ``pool_processes`` supervises them: when a rank exits non-zero
the survivors are terminated, every rank's state is written to stderr
(exited with its code, killed by a signal, or running), and the launcher
exits with that rank's code (1 for a signal); a watchdog ends a job that
outlives it. ::

    python -m antmmf_torch.utils.launch --nproc_per_node 2 \\
        -m antmmf_torch.run --config projects/base_vtp/configs/video_retrieval.yml \\
        training_parameters.mesh.data 2

``--master_port 0`` (the default) takes a free port.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence

POLL_SECONDS = 1.0
WATCHDOG_SECONDS = 7 * 24 * 3600


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def pool_processes(processes: List[subprocess.Popen], poll_seconds: float = POLL_SECONDS,
                   watchdog_seconds: float = WATCHDOG_SECONDS) -> int:
    """Supervise ranks; returns the job's exit code."""
    start = time.time()
    try:
        while True:
            codes = [p.poll() for p in processes]
            if any(c is not None and c != 0 for c in codes):
                bad = next(i for i, c in enumerate(codes) if c is not None and c != 0)
                # every rank's state: a rank that left a collective early
                # (exited 0 or killed) shows beside the rank that failed in it
                sys.stderr.write(f"[launch] rank {bad} {_exit_text(codes[bad])} ("
                                 + "; ".join(f"rank {i}: {_exit_text(c)}"
                                             for i, c in enumerate(codes) if i != bad)
                                 + "); terminating survivors\n")
                _end(processes)
                return codes[bad] if codes[bad] > 0 else 1
            if all(c == 0 for c in codes):
                return 0
            if time.time() - start > watchdog_seconds:
                sys.stderr.write("[launch] watchdog expired; killing job\n")
                _end(processes)
                return 1
            time.sleep(poll_seconds)
    except KeyboardInterrupt:
        _end(processes)
        return 130


def _exit_text(code: Optional[int]) -> str:
    if code is None:
        return "running"
    if code < 0:
        try:
            return f"killed by {signal.Signals(-code).name}"
        except ValueError:
            return f"killed by signal {-code}"
    return f"exited with {code}"


def _end(processes: List[subprocess.Popen]) -> None:
    for p in processes:
        if p.poll() is None:
            p.terminate()
    for p in processes:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(script_args: Sequence[str], nproc: int = 2, master_port: int = 0,
           poll_seconds: float = POLL_SECONDS, extra_env: Optional[dict] = None,
           watchdog_seconds: float = WATCHDOG_SECONDS) -> int:
    """Run ``python <script_args>`` as ``nproc`` ranks (``script_args`` may
    begin with ``-m module``); returns the job's exit code."""
    port = master_port or free_port()
    processes: List[subprocess.Popen] = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "WORLD_SIZE": str(nproc), "RANK": str(rank), "LOCAL_RANK": str(rank),
                    "LOCAL_WORLD_SIZE": str(nproc)})
        env.update(extra_env or {})
        processes.append(subprocess.Popen([sys.executable, *script_args], env=env))
    return pool_processes(processes, poll_seconds, watchdog_seconds)


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    # the launcher's options end at ``-m``, ``--`` or the script
    cut = next((i for i, a in enumerate(argv) if a in ("-m", "--") or not a.startswith("-")
                and (i == 0 or argv[i - 1] not in ("--nproc_per_node", "--master_port"))),
               len(argv))
    parser = argparse.ArgumentParser("antmmf_torch.utils.launch", allow_abbrev=False)
    parser.add_argument("--nproc_per_node", type=int, default=2)
    parser.add_argument("--master_port", type=int, default=0)
    args = parser.parse_args(argv[:cut])
    script_args = argv[cut + 1:] if argv[cut:cut + 1] == ["--"] else argv[cut:]
    if not script_args or script_args == ["-m"]:
        parser.error("a script or -m module is required")
    sys.exit(launch(script_args, args.nproc_per_node, args.master_port))


if __name__ == "__main__":
    main()
