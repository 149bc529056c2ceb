"""Training in a child process.

Counterpart of ``linna_tpu/train_entry.py``.  With
``params["train_subprocess"]`` the orchestrator writes the request as
``train_request.json`` + ``train_request.npz`` in the iteration directory
and runs

    python -m linna_tpu_torch.train_entry <outdir_in> [--device DEV] [--verbose]

which runs :func:`linna_tpu_torch.orchestrator.train_emulator` and leaves
the usual ``finish.json`` marker.  The request names the device the parent
trains on; ``--device`` overrides it.  A request written by either package
runs in the other: the JAX package ignores ``device``, and a request without
it trains on the port's default device.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REQUEST_JSON = "train_request.json"
REQUEST_NPZ = "train_request.npz"

__all__ = ["write_request", "run_request", "main"]


def write_request(
    outdir_in: str,
    outdir_list,
    data,
    cov,
    sigma,
    dolog10index,
    ypositive: bool,
    model_name: str,
    params: dict,
    usebest: bool,
    seed: int = 1234,
    device=None,
) -> None:
    os.makedirs(outdir_in, exist_ok=True)
    np.savez(os.path.join(outdir_in, REQUEST_NPZ), data=data, cov=cov, sigma=sigma)
    # JSON values only; a dict such as ``linearmodel: {norder: 2}`` is kept
    # (the JAX package's request drops it, and its child then trains
    # without the pre-model)
    clean = {
        k: v
        for k, v in params.items()
        if isinstance(v, (int, float, str, bool, list, dict, type(None)))
    }
    request = {
        "outdir_list": list(outdir_list),
        # `is not None`: a numpy index array raises on bool(), and an empty
        # list stays an explicit []
        "dolog10index": (
            [int(i) for i in dolog10index] if dolog10index is not None else None
        ),
        "ypositive": bool(ypositive),
        "model_name": model_name,
        "params": clean,
        "usebest": bool(usebest),
        "seed": int(seed),
    }
    if device is not None:
        request["device"] = str(device)
    with open(os.path.join(outdir_in, REQUEST_JSON), "w") as f:
        json.dump(request, f)


def run_request(outdir_in: str, verbose: bool = False, device=None) -> None:
    """Train from the request in ``outdir_in`` on ``device``, else on the
    request's device, else on the default device."""
    from .orchestrator import train_emulator

    with open(os.path.join(outdir_in, REQUEST_JSON)) as f:
        req = json.load(f)
    with np.load(os.path.join(outdir_in, REQUEST_NPZ)) as arrs:
        data, cov, sigma = arrs["data"], arrs["cov"], arrs["sigma"]
    train_emulator(
        outdir_in,
        req["outdir_list"],
        data,
        cov,
        sigma,
        req["dolog10index"],
        req["ypositive"],
        req["model_name"],
        req["params"],
        usebest=req["usebest"],
        seed=req["seed"],
        verbose=verbose,
        device=device if device is not None else req.get("device"),
    )


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m linna_tpu_torch.train_entry")
    parser.add_argument("outdir_in")
    parser.add_argument("--device", default=None, help="overrides the request's device")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    run_request(args.outdir_in, verbose=args.verbose, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
