"""The yardstick: the H100's published peaks, the least time a kernel could
take from its shapes, and the model FLOPs of a VAE step or decode.

The peaks and ``bound`` are copies of ``chip_smoke.py``'s (``PEAK_*``,
``bound``, the bytes of ``check_kernel_case``, ``time_bwd_bf16``,
``check_output_layer_bwd`` and ``check_clip_adam``), kept here so that the
benchmark's arithmetic cannot move with the program. Times are in
milliseconds, as there.
"""

from __future__ import annotations

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

PEAKS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_FP32_FLOPS}


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the operations at ``peak_flops``
    and the bytes at the HBM's rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _size(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4}[dtype]


def decode_threshold_pack_ms(m: int, k: int, n: int, dtype: str) -> float:
    """``(h @ W + b) > 0`` packed 8 to 1: h (m, k) and W (k, n) in the
    operand dtype and b (n,) float32 read once, the packed bits written."""
    e = _size(dtype)
    nbytes = m * k * e + k * n * e + n * 4 + m * (n // 8)
    return bound(2.0 * m * k * n, nbytes, PEAKS[dtype])[0]


def output_layer_bwd_ms(b: int, h: int, d: int, dtype: str,
                        y_bytes: int | None = None) -> float:
    """dW, db and dh of the output layer and its masked BCE: logits and
    targets (b, d), mask (d,), h (b, h) and W (h, d) read, dW, db and dh
    written as float32; two products of 2 b h d operations each."""
    e = _size(dtype)
    y_bytes = e if y_bytes is None else y_bytes
    nbytes = (b * d * e + b * d * y_bytes + d * 4 + b * h * e + h * d * e + 4
              + (h * d + d + b * h) * 4)
    return bound(2 * 2.0 * b * h * d, nbytes, PEAKS[dtype])[0]


def clip_adam_ms(values: int, moment_dtype: str) -> float:
    """One clip + Adam + apply step: g, m, v, p read once, m, v, p written
    once (20 bytes a value with bf16 moments, 28 with float32)."""
    f32, m = 4, _size(moment_dtype)
    nbytes = values * (f32 + m + m + f32 + m + m + f32)
    return bound(15.0 * values, nbytes, PEAK_FP32_FLOPS)[0]


def vae_leaf_sizes(genes: int, hidden: int, latent: int) -> dict[str, int]:
    """Values of each trainable leaf of the VAE at a gene width ``genes``
    (the program pads it; pass the padded width for what its kernels
    touch): three encoder blocks, the two heads, three decoder blocks, the
    output layer."""
    g, h, lat = genes, hidden, latent
    block = lambda i, o: i * o + 3 * o  # noqa: E731  w, b, bn scale, bn bias
    return {"encoder/0": block(g, h), "encoder/1": block(h, h),
            "encoder/2": block(h, h), "mean": h * lat + lat,
            "logvar": h * lat + lat, "decoder/0": block(lat, h),
            "decoder/1": block(h, h), "decoder/2": block(h, h),
            "decoder/3": h * g + g}


def adam_values(genes: int, hidden: int, latent: int) -> int:
    return sum(vae_leaf_sizes(genes, hidden, latent).values())


def _products(genes: int, hidden: int, latent: int) -> list[tuple[int, int]]:
    """(in, out) of every product of the forward pass, input layer first."""
    g, h, lat = genes, hidden, latent
    return [(g, h), (h, h), (h, h), (h, lat), (h, lat), (lat, h), (h, h),
            (h, h), (h, g)]


def forward_flops(genes: int, hidden: int, latent: int) -> float:
    """Model FLOPs of one row's forward pass: 2 per multiply-add."""
    return sum(2.0 * i * o for i, o in _products(genes, hidden, latent))


def train_flops(genes: int, hidden: int, latent: int) -> float:
    """One training row: the forward, every weight's gradient and every
    input gradient but the input layer's, which no step needs."""
    fwd = forward_flops(genes, hidden, latent)
    return 3.0 * fwd - 2.0 * genes * hidden


def decode_flops(genes: int, hidden: int, latent: int) -> float:
    """One genome through the decoder: latent -> hidden -> hidden -> hidden
    -> genes."""
    g, h, lat = genes, hidden, latent
    return 2.0 * (lat * h + 2 * h * h + h * g)
