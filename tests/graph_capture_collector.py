"""A card-only probe of the CUDA graph captures and Python's collector.

A graphed chunk runner that nobody holds any more lives on in a cycle (its
graphs' step functions hold it) until the cyclic collector frees it, and
freeing it destroys its CUDA graphs.  This probe shows what happens when
that collection starts inside another runner's capture, and that
``ops.graphs.collector_paused`` keeps every collection out of the
captures.  Each experiment runs in a process of its own (a failed capture
leaves the process's captures unusable):

    python tests/graph_capture_collector.py dead|control|auto [--no-pause]

- ``dead``: a dead runner waits, and the step function calls
  ``gc.collect()`` while its graph is captured (the pause cannot stop an
  explicit collection: this shows the fault itself);
- ``control``: the same collection with no dead runner waiting;
- ``auto``: a dead runner waits and the collector's thresholds are
  (1, 1, 1), three times; counts the collections that start inside a
  capture.

``--no-pause`` captures without ``collector_paused``, as before it
existed.  Prints one JSON line; it is not collected by pytest.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from linna_tpu_torch.ops import graphs as OG  # noqa: E402
from linna_tpu_torch.samplers import graphs as G  # noqa: E402
from linna_tpu_torch.samplers import slicemove as S  # noqa: E402

OPTIONS = dict(a=2.0, n_leapfrog=10, max_depth=5, max_steps=100)


def main(experiment: str, pause: bool = True) -> dict:
    if not pause:
        OG.collector_paused = contextlib.nullcontext
    dev = torch.device("cuda:0")
    seen = {"collections_in_capture": 0, "explicit": 0}

    def plain(x):
        return -0.5 * (x * x).sum(-1)

    def collecting(x):
        if torch.cuda.is_current_stream_capturing():
            seen["explicit"] += 1
            gc.collect()
        return plain(x)

    def count(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            seen["collections_in_capture"] += 1

    def runner(seed, lp):
        g = torch.Generator(device=dev).manual_seed(seed)
        state = S.init_slice_state(g, 0.1 * torch.randn(64, 4, device=dev, generator=g), lp)
        r = G.graphed_chunks("zeus", lp, state, 10, **OPTIONS)
        r(state, 5)
        torch.cuda.synchronize()
        return r

    res: dict = {"experiment": experiment, "pause": pause}
    gc.callbacks.append(count)
    try:
        if experiment in ("dead", "control"):
            gc.disable()
            if experiment == "dead":
                dead = runner(1, plain)
                del dead
            runner(2, collecting)
        elif experiment == "auto":
            for trial in range(3):
                dead = runner(10 + trial, plain)
                del dead
                gc.set_threshold(1, 1, 1)
                runner(20 + trial, plain)
                gc.set_threshold(700, 10, 10)
        else:
            raise SystemExit(f"unknown experiment {experiment!r}")
        res["ok"] = True
    except RuntimeError as e:  # torch.AcceleratorError is one
        res["ok"] = False
        res["error"] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    res.update(seen)
    return res


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(json.dumps(main(sys.argv[1], pause="--no-pause" not in sys.argv[2:])), flush=True)
