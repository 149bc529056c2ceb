"""linna_tpu_torch: the PyTorch and CUDA port of linna-tpu for NVIDIA Hopper.

Module names mirror the JAX package ``linna_tpu`` (the reference, which this
package never imports).  Entry points run on ``cuda:0`` unless the caller
passes ``device="cpu"``; without a CUDA device they raise instead of moving
to the CPU on their own.  The emulator likelihood's hot path runs through
hand-written CUDA kernels (``ops/csrc/fused_mlp.cu``) when
``make_log_prob(..., use_fused=True)`` is asked for on a CUDA device.

The command line is ``python -m linna_tpu_torch.driver <method> <gpunode>
<yaml> [yamldir] [--device DEV]``; ``linna_tpu_torch.driver`` and
``linna_tpu_torch.train_entry`` are entry points, imported on use.
"""

from . import (  # noqa: F401
    config,
    data,
    device,
    likelihood,
    losses,
    nn,
    ops,
    orchestrator,
    parallel,
    pool,
    priors,
    sample_gen,
    samplers,
    train,
    transforms,
    utils,
)
from .orchestrator import (  # noqa: F401
    ml_sampler,
    ml_sampler_core,
    read_chain_and_cut,
    retrieve_ensemble_params,
    retrieve_model,
    retrieve_model_exist,
    retrieve_model_wrapper,
    train_emulator,
)
from .parallel.ensemble import EnsembleTrainer  # noqa: F401
from .train import Trainer  # noqa: F401

__version__ = "0.1.0"
