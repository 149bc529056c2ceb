"""Ensemble training over the ranks' (ens, data) grid (``ensemble``), and
the multi-process layer (``multihost``, ``mesh``, ``census``)."""
