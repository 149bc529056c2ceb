"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the kernel library from its cache
directory in the checkout, the inputs and weights made on the card from the
seed, the warm call) is ``setup_s``; then one measured window of about
``--seconds``; then, with ``--trace 1``, one more call under
``torch.profiler``; then the comparison with the plain reference that
decides ``correct``.  Standard error ends with each compared number beside
its limit; standard output ends with one JSON line.  Exits non-zero without
a result when no card (or fewer than the cell asks for) is there, and when
JAX, the JAX package or a root script of the repository was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Optional  # noqa: E402

from . import harness as H  # noqa: E402

# the program's kernel build and CUDA's own cache, at fixed paths inside the
# checkout: only a cell's first run there builds
CACHE = H.ROOT / ".bench_cache"


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_caches() -> None:
    os.environ["LINNA_COMPILE_CACHE"] = str(CACHE / "kernels")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            chips: int = 1, controls: bool = False, t_start: float = T_START,
            overrides: Optional[dict] = None) -> dict:
    """Run the cell once on ``device``, without looking for a card: returns
    ``line`` (the result line), ``out`` (everything the cell's kind
    returned), ``compared`` and ``setup_s``.  ``controls``: compute the
    control's readings too (``out["control"]``).  ``overrides``: keys of
    the configuration (``"config"``) and of the traffic mix
    (``"traffic"``) replaced, for a run at a size the CPU holds."""
    import torch

    from . import kinds

    bench = H.benchmark()
    entry = H.cell(bench, workload)
    overrides = overrides or {}
    cfg = {**H.config(bench, entry["config"]), **overrides.get("config", {})}
    mix = {**H.traffic(entry["traffic"], cfg), **overrides.get("traffic", {})}
    own = H.cell_data(workload)
    workdir = tempfile.mkdtemp(prefix=f"bench_{workload}_")
    try:
        out = kinds.KINDS[mix["kind"]](cfg, mix, own["unit_seconds"], seed, seconds, trace,
                                       device, workdir, controls=controls)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    setup_s = out["window_start"] - t_start
    metrics = H.metrics_line(bench, workload, out, trace, setup_s)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": out["memory_peak"]}
    traced = out["layer"].get("trace")
    if trace and traced is not None:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
    compared = H.checks(out["readings"], own["limits"])
    return {"line": H.result_line(out, metrics, dev, compared), "out": out,
            "compared": compared, "setup_s": setup_s}


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    bench = H.benchmark()
    chips = H.cell(bench, args.workload)["chips"]
    set_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        H.say(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    device = torch.device("cuda:0")
    res = execute(args.workload, args.seed, args.seconds, bool(args.trace), device, chips)
    bad = H.forbidden_modules(sys.modules)
    if bad:
        H.say(f"benchmark: modules the run may not load were loaded: {', '.join(bad)}")
        return 3
    out = res["out"]
    H.say(f"benchmark: {args.workload} seed {args.seed}: window {out['window_s']:.3f} s, "
          f"setup {res['setup_s']:.3f} s, reference {out['reference_s']:.3f} s")
    layer = out["layer"]
    phases = {**layer["trainer"]["phase_seconds"], **layer["trainer"]["speculation"]} \
        if layer["kind"] == "train" else layer["window"].get("sampler")
    H.say(f"benchmark: window phases {json.dumps(phases)}")
    for name, (value, limit) in res["compared"].items():
        H.say(f"check {name} {value!r} limit {limit!r}")
    # a number that is not finite (a gap with a row finite on one side only)
    # goes out as null
    line = json.loads(json.dumps(res["line"], default=float), parse_constant=lambda c: None)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
