"""What a run is given, made from ``--seed`` on the device in a few large
calls: the presence/absence matrix, the VAE's weights, the PRNG key the
program draws its noise and shuffles from, and the essential genes.
The program and the reference receive the same tensors.

The matrix follows the repo's synthetic gene model (``data/synthetic.py``
of both packages, ``write_presence_absence_csv``): 30 % of genes are core,
present at rate 0.97, the rest accessory, each at its own rate drawn from
U(0.05, 0.9).
"""

from __future__ import annotations

import numpy as np
import torch

CORE_SHARE, CORE_RATE = 0.3, 0.97
ACCESSORY_RATES = (0.05, 0.9)
MATRIX_BLOCK_ROWS = 2_000  # rows drawn per call: 0.44 GB of float32 at 55k genes


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def prng_key(seed: int, stream: int) -> np.ndarray:
    """Two uint32 words for stream ``stream`` of ``seed``: the key the
    program's state starts from (stream 0) or the sampler's root (1)."""
    words = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream])
    return words.generate_state(2, dtype=np.uint32)


def presence_matrix(gen: torch.Generator, rows: int, genes: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """(rows, genes) of {0, 1} in ``dtype`` on the generator's device."""
    dev = gen.device
    core = torch.rand(genes, generator=gen, device=dev) < CORE_SHARE
    lo, hi = ACCESSORY_RATES
    accessory = torch.rand(genes, generator=gen, device=dev) * (hi - lo) + lo
    rate = torch.where(core, torch.full_like(accessory, CORE_RATE), accessory)
    out = torch.empty((rows, genes), dtype=dtype, device=dev)
    for r in range(0, rows, MATRIX_BLOCK_ROWS):
        n = min(MATRIX_BLOCK_ROWS, rows - r)
        draw = torch.rand((n, genes), generator=gen, device=dev)
        out[r:r + n] = (draw < rate).to(dtype)
    return out


def leaf_shapes(genes: int, hidden: int, latent: int) -> dict[str, tuple]:
    """Every trainable leaf at the model's true widths, by its path."""
    g, h, lat = genes, hidden, latent
    shapes = {}
    for tree, dims in (("encoder", ((g, h), (h, h), (h, h))),
                       ("decoder", ((lat, h), (h, h), (h, h)))):
        for i, (a, b) in enumerate(dims):
            shapes[f"{tree}/{i}/w"] = (a, b)
            for leaf in ("b", "bn/scale", "bn/bias"):
                shapes[f"{tree}/{i}/{leaf}"] = (b,)
    for head in ("mean", "logvar"):
        shapes[f"{head}/w"], shapes[f"{head}/b"] = (h, lat), (lat,)
    shapes["decoder/3/w"], shapes["decoder/3/b"] = (h, g), (g,)
    return shapes


def vae_weights(gen: torch.Generator, genes: int, hidden: int, latent: int,
                trained: bool) -> tuple[dict, dict]:
    """(params, BatchNorm running statistics) at the true widths, float32.

    Weights are Xavier-uniform, U(-b, b) with b = sqrt(6 / (in + out)), as
    the program's and upstream's initializers draw them, all from one
    call. With ``trained`` False the rest is the initial state (zero
    biases, BatchNorm scale 1 and bias 0, running mean 0 and variance 1);
    with ``trained`` True, as a model that has learned would hold them,
    biases N(0, 0.1), BatchNorm scale U(0.75, 1.25), bias N(0, 0.1),
    running mean N(0, 0.1) and variance U(0.5, 2)."""
    dev = gen.device
    shapes = leaf_shapes(genes, hidden, latent)
    weights = [k for k in shapes if k.endswith("/w")]
    total = sum(int(np.prod(shapes[k])) for k in weights)
    flat = torch.rand(total, generator=gen, device=dev).mul_(2.0).sub_(1.0)
    params, off = {}, 0
    for k in weights:
        a, b = shapes[k]
        params[k] = flat[off: off + a * b].view(a, b).mul_((6.0 / (a + b)) ** 0.5)
        off += a * b
    vectors = [k for k in shapes if not k.endswith("/w")]
    stats = {}
    for k in vectors:
        n = shapes[k][0]
        if k.endswith("bn/scale"):
            params[k] = (torch.rand(n, generator=gen, device=dev) * 0.5 + 0.75
                         if trained else torch.ones(n, device=dev))
        else:
            params[k] = (torch.randn(n, generator=gen, device=dev) * 0.1
                         if trained else torch.zeros(n, device=dev))
    for tree in ("encoder", "decoder"):
        for i in range(3):
            n = shapes[f"{tree}/{i}/b"][0]
            mean = (torch.randn(n, generator=gen, device=dev) * 0.1 if trained
                    else torch.zeros(n, device=dev))
            var = (torch.rand(n, generator=gen, device=dev) * 1.5 + 0.5 if trained
                   else torch.ones(n, device=dev))
            stats[f"{tree}/{i}/mean"], stats[f"{tree}/{i}/var"] = mean, var
    return {k: params[k] for k in shapes}, stats


def essential_genes(seed: int, genes: int, count: int, most: int) -> dict:
    """``count`` essential genes, each mapped to 1 to ``most`` distinct
    gene columns, as the dataset maps a name to several positions."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 2])
    per = rng.integers(1, most + 1, size=count)
    cols = rng.choice(genes, size=int(per.sum()), replace=False)
    out, off = {}, 0
    for i, n in enumerate(per):
        out[f"ess{i:03d}"] = sorted(int(c) for c in cols[off: off + n])
        off += n
    return out
