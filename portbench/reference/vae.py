"""The plain reference of the VAE: its forward pass, losses, gradients and
clip + Adam update, and the decoder's threshold and packing, in float32
PyTorch with TF32 off. It imports nothing of the program; it follows the
upstream model (ucl-cssb/genome-minimizer-2): encoder 3 x [Linear ->
BatchNorm -> ReLU], mean and log-variance heads, the reparameterisation,
decoder 3 x [Linear -> BatchNorm -> ReLU] and an output Linear; a masked
BCE summed over genes and rows, a KL term under a linear or cosine beta,
the gene-abundance term and an L1 penalty over every trainable parameter.

``precision`` puts the products' operands, and the cotangents of their
backward, in a lower precision: ``"tf32"`` rounds them to TF32's 10
mantissa bits, ``"bfloat16"`` to bf16, ``"fp8"`` to float8 e4m3 under a
per-tensor scale; sums stay float32. Under bf16 and fp8 the logits and
each product's two gradients are stored in that precision too (the
logits' gradient passes through their rounding), as a compute dtype's
policy stores them. ``MOMENTS`` gives the precisions Adam's two moments
are stored in under a control: fp8 keeps the first in e4m3 and the
second, whose range is the square of the first's, in e5m2, each under a
per-leaf scale; TF32 keeps both at 10 mantissa bits. That is the control
a comparison has to fail. Weights are kept (in, out), as the program
keeps them.
"""

from __future__ import annotations

import math

import torch

BN_EPS = 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
FP8_MAX = 448.0  # the largest float8 e4m3 value
FP8E5_MAX = 57344.0  # the largest float8 e5m2 value
STORED = ("bfloat16", "fp8")  # precisions the logits are stored in too
MOMENTS = {"fp8": ("fp8", "fp8e5"), "tf32": ("tf32", "tf32")}


def set_ieee_float32() -> None:
    """float32 products in IEEE float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` (float32) rounded to ``precision``, returned as float32."""
    if precision == "float32":
        return t
    if precision == "tf32":  # round to nearest even on 10 mantissa bits
        bits = t.contiguous().view(torch.int32)
        low = bits & 0x1FFF
        keep = bits & ~0x1FFF
        up = (low > 0x1000) | ((low == 0x1000) & ((bits & 0x2000) != 0))
        return torch.where(up, keep + 0x2000, keep).view(torch.float32)
    if precision == "bfloat16":
        return t.to(torch.bfloat16).float()
    if precision == "fp8":
        scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    if precision == "fp8e5":
        scale = t.abs().amax().clamp_min(1e-30) / FP8E5_MAX
        return (t / scale).to(torch.float8_e5m2).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


class _Product(torch.autograd.Function):
    """``a @ b`` with its operands and its cotangent rounded to the
    precision, float32 sums; under a stored precision its gradients
    rounded too."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ar, br = round_to(a, precision), round_to(b, precision)
        ctx.save_for_backward(ar, br)
        ctx.precision = precision
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        p = ctx.precision
        gr = round_to(g.contiguous(), p)
        da, db = gr @ br.t(), ar.t() @ gr
        if p in STORED:  # each gradient returned in the precision, as stored
            da, db = round_to(da, p), round_to(db, p)
        return da, db, None


def product(a, b, precision: str = "float32"):
    if precision == "float32":
        return a @ b
    return _Product.apply(a, b, precision)


def block(x, p: dict, name: str, precision: str, stats: dict | None = None):
    """Linear -> BatchNorm -> ReLU: batch statistics (biased variance) in
    training, the running ones given in ``stats``."""
    y = product(x, p[f"{name}/w"], precision) + p[f"{name}/b"]
    if stats is None:
        mean = y.mean(dim=0)
        var = (y - mean).square().mean(dim=0)
    else:
        mean, var = stats[f"{name}/mean"], stats[f"{name}/var"]
    y = (y - mean) * torch.rsqrt(var + BN_EPS) * p[f"{name}/bn/scale"] \
        + p[f"{name}/bn/bias"]
    return torch.relu(y)


def decoder_hidden(z, p: dict, precision: str, stats: dict | None = None):
    h = z
    for i in range(3):
        h = block(h, p, f"decoder/{i}", precision, stats)
    return h


def forward(x, eps, p: dict, precision: str):
    """Train-mode forward: (logits, mu, logvar)."""
    h = x
    for i in range(3):
        h = block(h, p, f"encoder/{i}", precision)
    mu = product(h, p["mean/w"], precision) + p["mean/b"]
    logvar = product(h, p["logvar/w"], precision) + p["logvar/b"]
    z = mu + torch.exp(0.5 * logvar) * eps
    h = decoder_hidden(z, p, precision)
    logits = product(h, p["decoder/3/w"], precision) + p["decoder/3/b"]
    if precision in STORED:  # kept in that precision, as the products' operands
        logits = logits + (round_to(logits.detach(), precision) - logits.detach())
    return logits, mu, logvar


def beta(loss: dict, epoch: int, counter: int) -> float:
    """The KL weight: linear from ``min_beta`` to ``max_beta`` over
    ``n_epochs``, or cosine over ``T`` loss calls (every call counts,
    validation too; 32 a epoch)."""
    lo, hi = loss["min_beta"], loss["max_beta"]
    if loss["kl_schedule"] == "linear":
        return lo + (hi - lo) * epoch / loss["n_epochs"]
    t = (epoch * 32 + counter) % loss["T"]
    return lo + (hi - lo) / 2 * (1 + math.cos(math.pi * t / loss["T"]))


def losses(x, eps, p: dict, loss: dict, epoch: int, counter: int,
           precision: str = "float32", latent: dict | None = None) -> dict:
    """Each loss component of one batch, and their total; ``latent``, if
    given, receives the batch's ``mu`` and ``logvar``."""
    logits, mu, logvar = forward(x, eps, p, precision)
    if latent is not None:
        latent.update(mu=mu.detach(), logvar=logvar.detach())
    out = {"reconstruction": (torch.nn.functional.softplus(logits)
                              - logits * x).sum(),
           "kl_divergence": beta(loss, epoch, counter) * (
               -0.5 * (1.0 + logvar - mu.square() - torch.exp(logvar)).sum())}
    if loss.get("gamma_start") is not None:
        gamma = loss["gamma_start"] + (loss["gamma_end"] - loss["gamma_start"]) \
            * epoch / loss["n_epochs"]
        out["gene_abundance"] = loss.get("weight", 1.0) * gamma * \
            torch.sigmoid(logits).sum(dim=0).abs().sum()
    if loss.get("lambda_l1"):
        out["l1_regularization"] = loss["lambda_l1"] * sum(
            v.abs().sum() for v in p.values())
    out["total"] = sum(out.values())
    return out


def clip_adam(p: dict, g: dict, m: dict, v: dict, step: int, lr: float,
              max_norm: float, stored: tuple[str, str] | None = None) -> None:
    """Clip by the global norm, then one Adam step, in place; with
    ``stored``, each moment is rounded to its precision as it is kept."""
    norm = torch.sqrt(sum(t.double().square().sum() for t in g.values())).float()
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    bc1, bc2 = 1.0 - ADAM_B1 ** step, 1.0 - ADAM_B2 ** step
    with torch.no_grad():
        for k in p:
            gk = g[k] * scale
            m[k].mul_(ADAM_B1).add_((1 - ADAM_B1) * gk)
            v[k].mul_(ADAM_B2).add_((1 - ADAM_B2) * gk.square())
            if stored is not None:
                m[k].copy_(round_to(m[k], stored[0]))
                v[k].copy_(round_to(v[k], stored[1]))
            p[k].sub_(lr * (m[k] / bc1) / ((v[k] / bc2).sqrt() + ADAM_EPS))


def unpack_rows(packed: torch.Tensor, genes: int) -> torch.Tensor:
    """Packed rows (gene j in bit j % 8 of byte j // 8) -> (rows, genes)
    uint8 of {0, 1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :genes]
