"""Plain building blocks of the reference: arithmetic, padding, convolutions.

Plain PyTorch, NHWC at every function, float32 parameters. Nothing here
imports the program under test or any JAX package: these are frozen copies
of the semantics the program computes, written out again.

`Arith` is the precision a model computes its products in. The reference
is `Arith("f32")`: every convolution and matrix product in float32 with
TF32 off (the caller turns TF32 off, `no_tf32`). The control of the
benchmark's comparison puts the same reference in the program's place one
precision step below the configuration's: `Arith("fp8")` rounds both
operands of every product to float8 e4m3 with a per-tensor scale (the
largest magnitude mapped to 448; their gradients, in the backward, to
float8 e5m2 scaled alike, the usual fp8 training recipe), `Arith("bf16")`
rounds them to bfloat16; the products still accumulate in float32.

Each parameter carries the rule its seeded value is drawn by
(`rule_of`, read by `benchmark/weights.py`): ("uniform", bound),
("const", value), ("log_uniform", lo, hi) for log(U(lo, hi)), and
("inv_softplus_log_uniform", lo, hi, floor) for Mamba2's dt bias.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

def _scaled(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """`t` rounded to the float8 `dtype` under a per-tensor scale that maps
    its largest magnitude to `top`, back in float32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (t.float() * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """Scaled e4m3 rounding forward, scaled e5m2 rounding of the gradient."""

    @staticmethod
    def forward(ctx, t):
        return _scaled(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2, 57344.0)


class Arith:
    """The precision of a model's products: "f32", "bf16" or "fp8"."""

    def __init__(self, kind: str = "f32") -> None:
        if kind not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """`t` rounded to this precision and returned in float32."""
        if self.kind == "f32":
            return t.float()
        if self.kind == "bf16":
            return t.to(torch.bfloat16).float()
        return _Fp8.apply(t)

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
        """VALID convolution of NHWC `x` with the OIHW kernel `w`."""
        y = F.conv2d(self.q(x).permute(0, 3, 1, 2), self.q(w), stride=stride)
        return y.permute(0, 2, 3, 1)

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ wᵀ over the last axis of `x` (`w` [out, in])."""
        return torch.matmul(self.q(x), self.q(w).t())

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN, restored
    on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def param(module: nn.Module, name: str, shape: tuple, rule: tuple) -> None:
    """Register an empty float32 parameter `name` on `module` with the rule
    its seeded value is drawn by."""
    module.register_parameter(name, nn.Parameter(torch.empty(shape)))
    module.__dict__.setdefault("_rules", {})[name] = rule


def rules(model: nn.Module) -> dict:
    """{parameter name: draw rule} of every parameter of `model`, in
    `named_parameters` order."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, rule in mod.__dict__.get("_rules", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = rule
    return {n: out[n] for n, _ in model.named_parameters()}


def fan_in_bound(fan_in: int) -> tuple:
    """torch's Conv2d/Linear default: U(±1/sqrt(fan_in))."""
    return ("uniform", 1.0 / math.sqrt(fan_in))


def pad2d(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pad H and W of NHWC `x` by `pad` ("zeros", "reflect", "replicate")."""
    if pad == 0:
        return x
    tmode = {"zeros": "constant", "reflect": "reflect", "replicate": "replicate"}[mode]
    return F.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode=tmode).permute(0, 2, 3, 1)


def act(x: torch.Tensor, kind: str | None, slope: float = 0.2) -> torch.Tensor:
    if kind is None:
        return x
    if kind == "relu":
        return F.relu(x)
    if kind == "leakyrelu":
        return F.leaky_relu(x, slope)
    raise ValueError(f"unknown activation {kind!r}")


class Conv(nn.Module):
    """Conv weight [out, in, k, k] and bias [out] on NHWC input that the
    caller has padded."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1) -> None:
        super().__init__()
        self.stride = stride
        bound = fan_in_bound(cin * k * k)
        param(self, "weight", (cout, cin, k, k), bound)
        param(self, "bias", (cout,), bound)

    def forward(self, x: torch.Tensor, arith: Arith) -> torch.Tensor:
        return arith.conv2d(x, self.weight, self.stride) + self.bias


class BatchNorm(nn.Module):
    """Batch statistics over N, H, W (biased variance, eps 1e-5), affine
    `scale` and `bias`; no running statistics."""

    def __init__(self, ch: int) -> None:
        super().__init__()
        param(self, "scale", (ch,), ("const", 1.0))
        param(self, "bias", (ch,), ("const", 0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), unbiased=False)
        return (x - mean) / torch.sqrt(var + 1e-5) * self.scale + self.bias


class ConvBlock(nn.Module):
    """pad → conv → optional batch norm → activation."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1, padding: int = 0,
                 padding_mode: str = "zeros", norm: bool = False, act_type: str | None = "relu"):
        super().__init__()
        self.padding, self.padding_mode, self.act_type = padding, padding_mode, act_type
        self.conv = Conv(cin, cout, k, stride)
        self.norm = BatchNorm(cout) if norm else None

    def forward(self, x: torch.Tensor, arith: Arith) -> torch.Tensor:
        x = self.conv(pad2d(x, self.padding, self.padding_mode), arith)
        if self.norm is not None:
            x = self.norm(x)
        return act(x, self.act_type)


class MultiScaleEncoder(nn.Module):
    """Three parallel convs (k = 1, 3, 5, each padded by (k−1)/2 in the
    model's padding mode) concatenated over channels; per-branch leaky
    slopes (0 = ReLU)."""

    def __init__(self, cin: int, features: int, slopes: tuple, padding_mode: str) -> None:
        super().__init__()
        self.slopes, self.padding_mode = slopes, padding_mode
        self.branches = nn.ModuleList(Conv(cin, features, k) for k in (1, 3, 5))

    def forward(self, x: torch.Tensor, arith: Arith) -> torch.Tensor:
        outs = []
        for conv, slope in zip(self.branches, self.slopes):
            y = conv(pad2d(x, conv.weight.shape[-1] // 2, self.padding_mode), arith)
            outs.append(F.relu(y) if slope == 0.0 else F.leaky_relu(y, slope))
        return torch.cat(outs, dim=-1)
