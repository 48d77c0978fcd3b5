"""The decoder's FLOPs of every genome of the window over the window's
time and the bf16 peak (the cell's compute dtype), in percent."""

from portbench import roofline as R


def read(record):
    if record["driver"] != "sample":
        return None
    flops = record["genomes"] * R.decode_flops(record["genes"], record["hidden"],
                                               record["latent"])
    return 100.0 * flops / (record["window_s"] * R.PEAKS[record["compute_dtype"]])
