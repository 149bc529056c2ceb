"""All K ensemble members trained as one batched program on one device.

Counterpart of ``linna_tpu/parallel/ensemble.py`` without the device mesh:
the K members' parameters are the rows of one (K, P) tensor, every step is
one batched forward/backward and one AdamW update of all rows, and each
member keeps its own random stream, learning rate, weight decay, supervisor
and checkpoints (see :mod:`linna_tpu_torch.train`).  ``outdirs[k]`` and
``seeds[k]`` give member k the artifacts and stream of a one-member
``Trainer(outdir=outdirs[k], seed=seeds[k])``: member 0 writes into the
iteration directory and member k into its ``ens_k/``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..train import _MemberStack

__all__ = ["EnsembleTrainer"]


class EnsembleTrainer(_MemberStack):
    """Train K ensemble members together on one device:
    ``EnsembleTrainer(spec, transforms, loss_state, outdirs, seeds,
    device=...)``, one output directory and seed per member; a
    ``linearmodel`` is one frozen pre-model shared by every member."""

    _plot_first_chunk = True

    @property
    def best_val_loss(self) -> np.ndarray:
        return self.best_val_losses

    def train(self, train_x, train_y, val_x, val_y, num_epochs: int, batch_size: int,
              **kwargs) -> Tuple[List[List[float]], List[List[np.ndarray]]]:
        """The supervised loop of every member; per-member (train_losses,
        val_metrics) lists mirroring ``Trainer.train``."""
        return self._train(train_x, train_y, val_x, val_y, num_epochs, batch_size, **kwargs)
