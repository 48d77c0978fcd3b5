"""The output layer's backward (``ops/kernels.py::output_layer_bwd``, its
cotangent pass, its two products and the split-K sum) over the traced
epochs: the least time of each call from its shapes, summed, over the
device time of the route's kernels, in percent."""

from portbench import roofline as R
from portbench import trace

KERNELS = ("dl_pass_kernel", "splitk_sum_kernel", "gm2::gemm_kernel<",
           "gm2::sgemm::sgemm_kernel<")


def read(record):
    tr = record.get("trace")
    if record["driver"] != "train" or tr is None:
        return None
    seconds = trace.kernel_seconds(tr, KERNELS)
    calls = tr["launches"].get("output_layer_bwd", 0)
    if seconds <= 0 or calls != tr["epochs"] * len(record["train_batches"]):
        return None
    least_ms = tr["epochs"] * sum(
        R.output_layer_bwd_ms(b, record["hidden"], record["genes_padded"],
                              record["compute_dtype"])
        for b in record["train_batches"])
    return 100.0 * least_ms / 1e3 / seconds
