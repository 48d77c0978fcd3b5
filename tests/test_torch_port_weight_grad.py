"""The bf16 product's weight gradient (``ops/kernels.py::weight_grad_bf16``)
on the CPU: its plain version bit-equal to the route the product's backward
took before the kernel, the wrapper's refusals, its place among the counted
kernels, and the name of its CUDA kernel against the patterns by which the
benchmark's readers find the other kernels' device time."""

import re
from pathlib import Path

import pytest
import torch

from genome_minimizer_2_torch.ops import kernels as K

CSRC = Path(K.__file__).resolve().parents[1] / "csrc"

# what the readers of the other kernels' device time look for in a trace
# (portbench/metrics/roofline_pct.*.py)
OTHER_READERS = ("gm2::gemm_kernel<", "dl_pass_kernel", "splitk_sum_kernel",
                 "gm2::cl::gemm_kernel<", "gm2::sgemm::sgemm_kernel<",
                 "clip_adam_kernel")
OWN_READER = "gm2::wgrad::"  # portbench/metrics/roofline_pct.weight_grad.py


def _old_route(x, g):
    """The backward's route before the kernel: the cotangent split into two
    bf16 terms, each times x^T with float32 sums, added, rounded to bf16
    and back."""
    hi = g.to(torch.bfloat16)
    lo = (g - hi.float()).to(torch.bfloat16)
    xt = x.t().float()
    return (xt @ hi.float() + xt @ lo.float()).to(torch.bfloat16).to(torch.float32)


@pytest.mark.parametrize("d, n", [(55, 8), (1003, 64), (384, 40)])
@pytest.mark.parametrize("rows", [1, 7, 32])
def test_plain_version_bit_equal_to_the_old_route(rows, d, n):
    gen = torch.Generator().manual_seed(1000 * rows + d + n)
    x = torch.randn(rows, d, generator=gen).to(torch.bfloat16)
    g = torch.randn(rows, n, generator=gen) * 1e-2
    got = K.weight_grad_bf16(x, g)
    assert got.dtype == torch.float32 and tuple(got.shape) == (d, n)
    assert torch.equal(got, _old_route(x, g))
    assert torch.equal(got, got.to(torch.bfloat16).float())


_BF = dict(dtype=torch.bfloat16)


@pytest.mark.parametrize("x, g", [
    (torch.zeros(4, 8, **_BF), torch.zeros(5, 8)),              # rows differ
    (torch.zeros(4, 8), torch.zeros(4, 8)),                     # x not bf16
    (torch.zeros(4, 8, **_BF), torch.zeros(4, 8, **_BF)),       # g not float32
    (torch.zeros(8, **_BF), torch.zeros(4, 8)),                 # x not 2-D
    (torch.zeros(4, 8, **_BF), torch.zeros(4, 2, 4)),           # g not 2-D
    (torch.zeros(4, 8, device="meta", **_BF),
     torch.zeros(4, 8, device="meta")),                         # not a card
    (torch.zeros(4, 8, **_BF), torch.zeros(4, 8, device="meta")),  # two devices
], ids=["rows", "x-dtype", "g-dtype", "x-1d", "g-3d", "meta", "mixed"])
def test_wrapper_refuses_operands_the_kernel_cannot_take(x, g):
    with pytest.raises(ValueError):
        K.weight_grad_bf16(x, g)


def test_launches_counted_with_the_other_kernels(monkeypatch):
    assert K.weight_grad_bf16 in K.KERNELS
    for fn in K.KERNELS:
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "replayed", 0)
    # a replay of a captured graph that recorded 8 launches of it
    K.add_launch_counts({fn.__name__: 8 * (fn is K.weight_grad_bf16)
                         for fn in K.KERNELS})
    assert K.launch_counts()["weight_grad_bf16"] == 8
    assert K.weight_grad_bf16.replayed == 8
    K.set_launch_counts({name: 0 for name in K.launch_counts()})
    assert K.weight_grad_bf16.launches == 0
    # the plain version launches nothing
    K.weight_grad_bf16(torch.zeros(2, 8, **_BF), torch.zeros(2, 8))
    assert K.weight_grad_bf16.launches == 0


def _global_names(path: Path) -> list[str]:
    """The qualified names of the ``__global__`` functions a CUDA source
    defines, as a trace's demangled names begin (anonymous namespaces as
    the demangler prints them)."""
    text = re.sub(r"//[^\n]*", "", path.read_text())
    token = re.compile(r"namespace\s+(\w*)\s*\{|\{|\}|__global__\s+void\s+"
                       r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    stack, names = [], []
    for m in token.finditer(text):
        if m.group(0).startswith("namespace"):
            stack.append(m.group(1) or "(anonymous namespace)")
        elif m.group(0) == "{":
            stack.append(None)
        elif m.group(0) == "}":
            stack.pop()
        else:
            names.append("::".join([s for s in stack if s] + [m.group(2)]))
    return names


def test_name_parser_finds_the_readers_kernels():
    found = [n for f in ("gemm_sm90.cuh", "output_layer_bwd.cu", "clip_adam.cu")
             for n in _global_names(CSRC / f)]
    for pattern in ("gm2::gemm_kernel<", "dl_pass_kernel", "splitk_sum_kernel",
                    "clip_adam_kernel"):
        assert any(pattern in n + "<" for n in found), (pattern, found)


def test_kernel_name_holds_no_other_readers_pattern():
    names = _global_names(CSRC / "weight_grad_bf16.cu")
    assert names
    for name in names:
        for shown in (name + "<", name + "("):
            assert OWN_READER in shown
            assert not [p for p in OTHER_READERS if p in shown], shown
