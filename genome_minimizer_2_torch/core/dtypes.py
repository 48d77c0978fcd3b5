"""Dtype policy and device resolution.

Same policy as the JAX package: parameters stay float32 (master weights),
matmul operands are cast to a configurable ``compute`` dtype, products
accumulate in float32. ``"auto"`` resolves to bfloat16 on a CUDA device and
float32 on the CPU, where the port is held to the JAX package at float32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    compute: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute)

    @property
    def logits_dtype(self) -> torch.dtype:
        """Storage dtype of materialized (B, ~55k) decoder logits: the
        compute dtype, as in the JAX package (accumulation stays f32)."""
        return self.compute_dtype


FULL = Policy("float32")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; asking for CUDA on a host without a card raises instead of
    silently running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_compute_dtype(name: str, device_type: str) -> str:
    """``"auto"`` means bfloat16 on CUDA and float32 on the CPU."""
    if name != "auto":
        return name
    return "bfloat16" if device_type == "cuda" else "float32"


def resolve_policy(name: str, device_type: str) -> Policy:
    return Policy(resolve_compute_dtype(name, device_type))


def require_ieee_float32_matmul() -> None:
    """Raise unless float32 products on CUDA run in IEEE float32. The port
    never sets the process-global TF32 switches itself: the CLI and
    ``chip_smoke.py`` turn them off once at start, and library code only
    checks them."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the float32 policy needs IEEE float32 matmuls, but TF32 is on "
            "(torch.backends.cuda.matmul.allow_tf32 / "
            "torch.set_float32_matmul_precision); turn it off at start")


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the nearest multiple."""
    return ((x + multiple - 1) // multiple) * multiple
