"""Per-rank entry point: the YAML driver run SPMD over several processes.

Counterpart of ``examples/pod_launch.py``:

    python -m linna_tpu_torch.launch <method> <yaml> <yamldir> [--device DEV] [--backend B]

started once per rank, with the cluster in the environment:
``LINNA_COORDINATOR_ADDRESS=host:port LINNA_NUM_PROCESSES=N
LINNA_PROCESS_ID=k``, or torchrun's variables (``torchrun --nproc-per-node
N -m linna_tpu_torch.launch ...``).  Every rank runs the same driver
(:mod:`linna_tpu_torch.driver`); the orchestrator gates the writes to rank 0
and puts barriers between phases.  The device defaults to
``cuda:<LOCAL_RANK>`` (``cuda:0`` without it) and the backend to ``nccl`` on
a card, ``gloo`` on the CPU; two ranks on one card need ``--backend gloo``,
and the CPU ``--device cpu``.  Without a cluster in the environment this is
the one-process driver.

:func:`run_ranks` starts such a cluster on this host: one process a command,
each given the ``LINNA_*`` variables and one free localhost port.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

# the directory that holds the package: the ranks' working directory
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    """A free localhost port for a process group's coordinator."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(cmds, logdir: str, timeout: float) -> list:
    """Start one process per command as the ranks of one cluster (the
    ``LINNA_*`` variables, a free localhost port), wait for all of them, and
    return their output; any rank that fails or outlives ``timeout`` fails
    the run, and no rank is left running.  Each rank's output is kept in
    ``logdir/rank_<k>.log``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT] + [p for p in sys.path if p]),
               LINNA_COORDINATOR_ADDRESS=f"localhost:{free_port()}",
               LINNA_NUM_PROCESSES=str(len(cmds)), OMP_NUM_THREADS="1")
    os.makedirs(logdir, exist_ok=True)
    logs = [open(os.path.join(logdir, f"rank_{k}.log"), "w+") for k in range(len(cmds))]
    procs = []
    try:
        for k, cmd in enumerate(cmds):
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=dict(env, LINNA_PROCESS_ID=str(k)),
                                          stdout=logs[k], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for k, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {k} outlived {timeout} s (a collective another "
                                     "rank skipped?)") from None
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
        for k, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                print(out[-6000:], flush=True)
                raise AssertionError(f"rank {k} exited with {p.returncode}")
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m linna_tpu_torch.launch")
    parser.add_argument("method")
    parser.add_argument("yaml")
    parser.add_argument("yamldir")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:<LOCAL_RANK>, else cuda:0)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="torch.distributed backend (default nccl on a card, gloo on the CPU)")
    args = parser.parse_args(argv)

    from .device import resolve_device
    from .parallel import multihost as MH

    device = resolve_device(args.device or f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    if device.type == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} was asked for and no CUDA device is available; "
                               "pass --device cpu to run on the CPU")
    # the process group before any other use of torch.distributed
    multi = MH.initialize(backend=args.backend, device=device)
    print(f"process {MH.process_index()}/{MH.process_count()}: device {device}, backend "
          f"{MH.backend() or 'none'}{'' if multi else ' (single-process)'}", flush=True)

    from . import driver

    rc = driver.main([args.method, "None", args.yaml, args.yamldir, "--device", str(device)])
    print(f"process {MH.process_index()} driver finished rc={rc}", flush=True)
    MH.barrier("pipeline-done")
    MH.shutdown()
    return rc


if __name__ == "__main__":
    sys.exit(main())
