"""Model FLOPs of the training window's epochs over its wall, as a share of
the card's peak in the training's compute type (bfloat16: the tensor
cores'; float32, as the program sets no TF32: the CUDA cores')."""

from benchmark.counts import emulator, peaks


def read(run):
    if run["kind"] != "train" or not run["trainer"]["epochs_run"]:
        return None
    per_epoch = emulator.train_epoch_flops(run["n_weights"], run["rows"], run["val_rows"],
                                           run["members"])
    peak = peaks.BF16_FLOPS if run["compute_dtype"] == "bfloat16" else peaks.F32_FLOPS
    return per_epoch * run["trainer"]["epochs_run"] / run["window_s"] / peak * 100.0
