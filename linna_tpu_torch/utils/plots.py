"""Diagnostic plots (reference: ``lr_tunning.png`` predictor_gpu.py:230,
``training_progress.png`` every 100 epochs predictor_gpu.py:422-442,
``trainniing.png`` util.py:1288-1305 — filename kept, typo and all, for
artifact-layout parity).  All plotting is best-effort: a headless or
matplotlib-less environment must never break training."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["plot_lr_range", "plot_training_progress"]


def _pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_lr_range(lrs: Sequence[float], losses: Sequence[float], path: str) -> None:
    plt = _pyplot()
    if plt is None:
        return
    try:
        fig, ax = plt.subplots()
        ax.plot(np.asarray(lrs)[: len(losses)], losses)
        ax.set_xscale("log")
        ax.set_xlabel("learning rate")
        ax.set_ylabel("smoothed loss")
        fig.savefig(path, dpi=80)
        plt.close(fig)
    except Exception:
        pass


def plot_training_progress(
    train_losses: Sequence[float],
    val_metrics: Sequence,
    path: str,
    batches_per_epoch: Optional[int] = None,
) -> None:
    plt = _pyplot()
    if plt is None:
        return
    try:
        fig, ax = plt.subplots()
        tl = np.asarray(train_losses, dtype=float)
        vm = np.asarray(val_metrics, dtype=float)
        # decimate long series: the plot is refreshed every ~100 epochs
        # during training and the per-batch loss trace grows to ~10^5
        # points by the end of a production run — rendering all of them
        # costs seconds per refresh for no visual difference at dpi=80
        max_pts = 2000
        if len(tl):
            x = np.arange(len(tl))
            if batches_per_epoch:
                x = x / batches_per_epoch
            stride = max(len(tl) // max_pts, 1)
            ax.plot(x[::stride], tl[::stride], label="train loss", alpha=0.6)
        if len(vm):
            stride = max(len(vm) // max_pts, 1)
            ax.plot(np.arange(len(vm))[::stride], vm[::stride, 0], label="val loss")
        ax.set_yscale("log")
        ax.set_xlabel("epoch")
        ax.legend()
        fig.savefig(path, dpi=80)
        plt.close(fig)
    except Exception:
        pass
