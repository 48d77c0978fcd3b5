"""The fused decode, threshold and pack (``ops/kernels.py::
decode_threshold_pack``) over the traced calls: the least time of a chunk
from its shapes (chunk x hidden x padded genes), times the launches, over
the device time of its kernel, in percent."""

from portbench import roofline as R
from portbench import trace

KERNELS = ("gm2::cl::gemm_kernel<", "gm2::sgemm::sgemm_kernel<")


def read(record):
    tr = record.get("trace")
    if record["driver"] != "sample" or tr is None:
        return None
    seconds = trace.kernel_seconds(tr, KERNELS)
    launches = tr["launches"].get("decode_threshold_pack", 0)
    if seconds <= 0 or launches == 0:
        return None
    least_ms = launches * R.decode_threshold_pack_ms(
        record["chunk_size"], record["hidden"], record["genes_padded"],
        record["compute_dtype"])
    return 100.0 * least_ms / 1e3 / seconds
