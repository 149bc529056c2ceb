"""All K ensemble members trained together, over the ranks' (ens, data)
grid.

Counterpart of ``linna_tpu/parallel/ensemble.py``: the members' parameters
are the rows of one (K, P) tensor, every step is one batched
forward/backward and one AdamW update of the rows, and each member keeps
its own random stream, learning rate, weight decay, supervisor and
checkpoints (see :mod:`linna_tpu_torch.train`).  Over several ranks the
members are split over the grid's ``ens`` rows and each member's
minibatches over its row's ``data`` ranks
(:func:`linna_tpu_torch.parallel.mesh.make_ensemble_mesh`): one gradient
``all_reduce`` a step within a row, nothing across rows.  ``outdirs[k]``
and ``seeds[k]`` give member k the artifacts and stream of a one-member
``Trainer(outdir=outdirs[k], seed=seeds[k])``: member 0 writes into the
iteration directory and member k into its ``ens_k/`` (rank 0 writes).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..train import _MemberStack
from .mesh import make_ensemble_mesh

__all__ = ["EnsembleTrainer"]


class EnsembleTrainer(_MemberStack):
    """Train K ensemble members together:
    ``EnsembleTrainer(spec, transforms, loss_state, outdirs, seeds,
    device=...)``, one output directory and seed per member; a
    ``linearmodel`` is one frozen pre-model shared by every member.
    ``mesh`` defaults to the grid of the current process group (one rank:
    every member here)."""

    _plot_first_chunk = True

    def __init__(self, spec, transforms, loss_state, outdirs, seeds, mesh=None, **kwargs):
        mesh = make_ensemble_mesh(len(seeds)) if mesh is None else mesh
        super().__init__(spec, transforms, loss_state, outdirs, seeds, mesh=mesh, **kwargs)

    @property
    def best_val_loss(self) -> np.ndarray:
        return self.best_val_losses

    def train(self, train_x, train_y, val_x, val_y, num_epochs: int, batch_size: int,
              **kwargs) -> Tuple[List[List[float]], List[List[np.ndarray]]]:
        """The supervised loop of every member; per-member (train_losses,
        val_metrics) lists mirroring ``Trainer.train``."""
        return self._train(train_x, train_y, val_x, val_y, num_epochs, batch_size, **kwargs)
