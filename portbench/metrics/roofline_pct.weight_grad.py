"""The bf16 product's weight gradients (``ops/kernels.py::weight_grad_bf16``,
one launch for each product of a step but the output layer's) over the
traced epochs: the least time of each launch from its bytes and operations,
summed, over the device time of the ``gm2::wgrad::`` kernels, in percent.
None where the program has no such kernel, or where the trace does not hold
every launch of its steps."""

from portbench import roofline as R
from portbench import trace

KERNELS = ("gm2::wgrad::",)


def products(genes: int, hidden: int, latent: int) -> list[tuple[int, int]]:
    """(in, out) of each product whose weight gradient the kernel computes:
    the encoder's three blocks, the two heads, the decoder's three blocks."""
    g, h, lat = genes, hidden, latent
    return [(g, h), (h, h), (h, h), (h, lat), (h, lat), (lat, h), (h, h), (h, h)]


def least_ms(rows: int, d_in: int, d_out: int) -> float:
    """One launch: x (rows, d_in) bf16 and the cotangent (rows, d_out)
    float32 read, dW (d_in, d_out) float32 written; two products (the
    cotangent's two bf16 terms) of 2 rows d_in d_out operations each."""
    nbytes = rows * d_in * 2 + rows * d_out * 4 + d_in * d_out * 4
    return R.bound(2 * 2.0 * rows * d_in * d_out, nbytes, R.PEAK_BF16_FLOPS)[0]


def step_ms(rows: int, genes: int, hidden: int, latent: int) -> float:
    return sum(least_ms(rows, i, o) for i, o in products(genes, hidden, latent))


def read(record):
    tr = record.get("trace")
    if record["driver"] != "train" or tr is None:
        return None
    dims = (record["genes_padded"], record["hidden"], record["latent"])
    seconds = trace.kernel_seconds(tr, KERNELS)
    steps = tr["epochs"] * len(record["train_batches"])
    calls = tr["launches"].get("weight_grad_bf16", 0)
    if seconds <= 0 or calls != steps * len(products(*dims)):
        return None
    least = tr["epochs"] * sum(step_ms(b, *dims) for b in record["train_batches"])
    return 100.0 * least / 1e3 / seconds
