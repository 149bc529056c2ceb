from . import backends, convergence, hmc, precondition, run, slicemove, stretch  # noqa: F401
