"""The model FLOPs of the window's training and validation rows over the
window's time and the peak of the cell's compute dtype, in percent. Every
product of the step counts at 2 FLOPs a multiply-add, the input layer's
input gradient, which no step needs, does not."""

from portbench import roofline as R


def read(record):
    if record["driver"] != "train":
        return None
    dims = (record["genes"], record["hidden"], record["latent"])
    flops = record["epochs"] * (record["train_rows"] * R.train_flops(*dims)
                                + record["val_rows"] * R.forward_flops(*dims))
    peak = R.PEAKS[record["compute_dtype"]]
    return 100.0 * flops / (record["window_s"] * peak)
