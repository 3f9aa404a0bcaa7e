"""Matmul FLOP counting of PyTorch functions, for MFU reporting (port of
`ecnf_tpu/ops/flops.py`).

`count_fn_flops` runs a function once under a counting dispatch mode
(`torch.utils._python_dispatch.TorchDispatchMode`) and adds up the matrix
products that reach the dispatcher: ``mm``, ``addmm``, ``bmm``,
``baddbmm``, ``mv``, ``addmv`` and ``dot`` (which ``matmul``, ``linear``
and ``einsum`` decompose into), ``matmul`` and ``linear`` should they
arrive whole, and ``convolution`` with its backward.  Each counts
``2 * batch * m * n * k``.
It counts work that ran, not a trace: autograd's backward is dispatched
too, so a train step's count holds its backward, as the JAX count of a
``jax.grad`` jaxpr does.  Elementwise FLOPs are not counted, as in JAX.

FLOPs go in the bf16 bucket when both operands of a product are bf16 and
in the f32 bucket otherwise (JAX's rule), so utilisation is read against
a mixed roofline:

    mfu = (flops_bf16 / peak_bf16 + flops_f32 / peak_f32) / seconds

What the dispatcher does not see is reported by the code that runs it:

- the three CUDA kernels, launched through ctypes, add what their plain
  versions would be counted as (`add`, called by each wrapper where it
  launches; the counts are `edge_tangent_flops`, `egcl_flops` and
  `fused_trace_flops`), so a kernel route and its plain route count the
  same;
- an adaptive solve (`ops.ode.odeint_adaptive`) flags the count
  ``has_while`` (`note_while`): its trip count depends on the data, so
  `mfu` gives None, as JAX's does for a ``while_loop``.  The count itself
  holds every trip that ran, where JAX's holds one.

The ``torch.func`` routes (`ops.divergence`) need nothing: their products
reach the mode, vmapped ones batched.  They are counted as they run, which
is more than JAX counts of its ``jax.linearize`` route: forward-mode AD
computes the product of each activation with a constant weight's zero
tangent densely (torch materialises that zero; JAX's symbolic zeros skip
it), and each vmapped call computes its own primal.

Fixed-step solves are host loops, so their count is steps times a stage,
which is what JAX's ``scan`` gives.  The callers count a solve or a step
in a call of its own, never inside a timed repetition.
"""
from dataclasses import dataclass
from math import prod
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

aten = torch.ops.aten


@dataclass
class FlopCount:
    bf16: float = 0.0
    f32: float = 0.0
    has_while: bool = False

    @property
    def total(self) -> float:
        return self.bf16 + self.f32

    def __add__(self, other: "FlopCount") -> "FlopCount":
        return FlopCount(
            self.bf16 + other.bf16,
            self.f32 + other.f32,
            self.has_while or other.has_while,
        )

    def scaled(self, k: float) -> "FlopCount":
        return FlopCount(self.bf16 * k, self.f32 * k, self.has_while)


def bucket(flops: float, *dtypes: torch.dtype) -> FlopCount:
    """``flops`` in the bf16 bucket when every operand dtype is bf16, else f32."""
    if all(d == torch.bfloat16 for d in dtypes):
        return FlopCount(bf16=flops)
    return FlopCount(f32=flops)


# Peak matmul throughput per card, FLOP/s, by `torch.cuda.get_device_name()`:
# NVIDIA's data sheet for the H100 SXM at 700 W, dense rates.  A card set
# below 700 W (`nvidia-smi --query-gpu=power.limit`) is read against the
# same published peak; print its power limit beside the reading.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12},
}


def f32_peak(peaks: dict) -> float:
    """The f32 bucket's peak: the card's fastest route to a product of f32
    accuracy, 3xTF32 (three TF32 products), under the matmul precision
    ``"highest"``; one TF32 product under ``"high"`` or ``"medium"``
    (`torch.get_float32_matmul_precision()`)."""
    if torch.get_float32_matmul_precision() == "highest":
        return peaks["tf32"] / 3
    return peaks["tf32"]


def mfu(count: FlopCount, seconds: float, device_kind: str, n_devices: int = 1) -> Optional[float]:
    """Model FLOP utilisation in [0, 1] against the mixed-precision roofline.

    ``device_kind`` is `torch.cuda.get_device_name()`.  Returns None when
    the device has no peak entry (the CPU, another card) or the count
    holds a data-dependent loop (``has_while``: adaptive solves).
    """
    peaks = PEAKS.get(device_kind)
    if peaks is None or count.has_while or seconds <= 0:
        return None
    denom = count.bf16 / peaks["bf16"] + count.f32 / f32_peak(peaks)
    return denom / (seconds * n_devices)


def _product(out, a, b) -> FlopCount:
    # 2 * (output elements) * (contraction length); the contraction is the
    # last axis of the first operand for every product counted here.
    return bucket(2.0 * out.numel() * a.shape[-1], a.dtype, b.dtype)


def _conv(out, x, w, groups) -> FlopCount:
    # 2 * output elements * (input channels / groups) * kernel spatial size.
    return bucket(2.0 * out.numel() * (x.shape[1] // groups) * prod(w.shape[2:]), x.dtype, w.dtype)


_RULES = {
    aten.mm: lambda out, a, b, *_, **__: _product(out, a, b),
    aten.bmm: lambda out, a, b, *_, **__: _product(out, a, b),
    aten.mv: lambda out, a, b, *_, **__: _product(out, a, b),
    aten.dot: lambda out, a, b, *_, **__: _product(out, a, b),
    aten.matmul: lambda out, a, b, *_, **__: _product(out, a, b),
    aten.linear: lambda out, x, w, *_, **__: _product(out, x, w),
    aten.addmm: lambda out, _c, a, b, *_, **__: _product(out, a, b),
    aten.baddbmm: lambda out, _c, a, b, *_, **__: _product(out, a, b),
    aten.addmv: lambda out, _c, a, b, *_, **__: _product(out, a, b),
    aten.convolution: lambda out, x, w, *args, **__: _conv(out, x, w, args[-1]),
}


def _conv_backward(outs, grad, x, w, bias_sizes, stride, padding, dilation, transposed,
                   output_padding, groups, output_mask) -> FlopCount:
    # The input and weight gradients each cost the forward's products.
    forward = _conv(grad, x, w, groups)
    return forward.scaled(sum(bool(m) for m in output_mask[:2]))


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = FlopCount()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in _RULES:
            self.count = self.count + _RULES[packet](out, *args, **kwargs)
        elif packet is aten.convolution_backward:
            self.count = self.count + _conv_backward(out, *args, **kwargs)
        return out


def _counters():
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, _Counter)]


def counting() -> bool:
    """Whether a `count_fn_flops` is running in this thread."""
    return bool(_counters())


def add(count: FlopCount) -> None:
    """Add work the dispatcher does not see (a kernel launched through
    ctypes) to every count that is running."""
    for counter in _counters():
        counter.count = counter.count + count


def note_while() -> None:
    """Flag every running count: a loop whose trip count depends on the
    data ran (JAX's ``while_loop``)."""
    for counter in _counters():
        counter.count.has_while = True


def count_fn_flops(fn, *args, **kwargs) -> FlopCount:
    """Run ``fn(*args, **kwargs)`` once and count its matmul FLOPs."""
    with _Counter() as counter:
        fn(*args, **kwargs)
    return counter.count
