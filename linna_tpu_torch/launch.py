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
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


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
