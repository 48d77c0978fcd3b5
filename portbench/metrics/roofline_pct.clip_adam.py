"""clip + Adam + apply (``ops/kernels.py::clip_adam_apply_leaves``) over the
traced epochs: the least time of a step's update from its bytes (every
leaf's values at their padded widths; 20 bytes a value with bf16 moments,
28 with float32), times the steps, over the device time of
``clip_adam_kernel``, in percent."""

from portbench import roofline as R
from portbench import trace


def read(record):
    tr = record.get("trace")
    if record["driver"] != "train" or tr is None:
        return None
    seconds = trace.kernel_seconds(tr, ("clip_adam_kernel",))
    steps = tr["epochs"] * len(record["train_batches"])
    if seconds <= 0 or tr["launches"].get("clip_adam_apply_leaves", 0) < steps:
        return None
    values = R.adam_values(record["genes_padded"], record["hidden"], record["latent"])
    least_ms = steps * R.clip_adam_ms(values, record["moment_dtype"])
    return 100.0 * least_ms / 1e3 / seconds
