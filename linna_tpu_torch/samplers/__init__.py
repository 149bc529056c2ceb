from . import backends, convergence, run, slicemove  # noqa: F401
