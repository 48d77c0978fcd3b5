"""The output layer and the masked BCE sum as one autograd function.

Forward: ``logits = h @ W + b`` (the policy's product, stored in its logits
dtype) and ``bce = sum((softplus(l) - l * y) * mask)``, the stable logits
form of ``ops/losses.py::bce_sum_logits`` in the JAX package. Backward: the
``output_layer_bwd`` kernel (``ops/kernels.py``), which builds the logits'
cotangent ``g (sigmoid(l) - y) mask + g_logits`` from the logits and writes
dW, db and dh, dW and dh rounded to the operand dtype; the JAX trainer gets
the same gradient from XLA's autodiff (``losses.py:196-201``). ``g_logits``
is the cotangent of the returned logits: absent for v0, the gene-abundance
term for v1-v3.
"""

from __future__ import annotations

import torch

from ..core.dtypes import Policy
from ..models.vae import matmul
from . import kernels as K


def bce_sum_logits(logits, targets, feature_mask) -> torch.Tensor:
    """sum BCE(sigmoid(logits), targets), the stable logits form
    ``softplus(l) - l * y``, masked, in float32."""
    lf = logits.float()
    per_elem = torch.nn.functional.softplus(lf) - lf * targets.float()
    return (per_elem * feature_mask).sum()


class _OutputLayerBCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, b, y, mask, policy: Policy):
        # the operands rounded once, here; the backward takes them as they are
        hc, wc = h.to(policy.compute_dtype), w.to(policy.compute_dtype)
        logits = (matmul(hc, wc, policy) + b).to(policy.logits_dtype)
        bce = bce_sum_logits(logits, y, mask)
        ctx.save_for_backward(logits, y, mask, hc, wc)
        ctx.set_materialize_grads(False)
        return bce, logits

    @staticmethod
    def backward(ctx, g_bce, g_logits):
        logits, y, mask, h, w = ctx.saved_tensors
        if g_bce is None:
            g_bce = torch.zeros((), dtype=torch.float32, device=logits.device)
        dw, db, dh = K.output_layer_bwd(logits, y, mask, h, w, g_bce, g_logits)
        return dh, dw, db, None, None, None


def output_layer_bce(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     y: torch.Tensor, mask: torch.Tensor, policy: Policy
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(bce sum (float32 0-dim), logits (B, D) in the logits dtype) for
    hidden activations h (B, H), the output weight W (H, D) and bias b (D,),
    targets y (B, D) and the gene mask (D,)."""
    return _OutputLayerBCE.apply(h, w, b, y, mask, policy)
