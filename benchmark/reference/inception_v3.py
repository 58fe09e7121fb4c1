"""Plain PyTorch InceptionV3 for DeepVariant: the benchmark's reference.

A frozen, functional copy of the published network (keras InceptionV3
with pooling='avg', a 0.2 dropout and a 3-class softmax head, as
DeepVariant's keras_modeling.py builds it; batch norm without scale,
epsilon 1e-3). It reads its weights from a flat map whose keys are the
state-dict names of the port's model (`stem1.conv.weight`,
`mixed0.b1x1.bn.mean`, `classification.bias`, ...), so the benchmark can
hand one set of seeded weights to both sides. It imports nothing of the
port.

One description of the architecture (`_network`) serves four uses:
`param_shapes` and `forward_flops` walk it on the meta device, `logits`
runs it in float32 (inference or training mode), and with `quant` every
convolution and the head take their input and weight rounded one
precision below bfloat16, with a per-tensor scale: 'fp8' to float8 e4m3
(in training the gradient of their output to e5m2), 'int8' to 8-bit
integers (the gradient too). That is the control.

TF32 is switched off by `full_float32()`; call it before running this on a
card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPSILON = 1e-3
NUM_CLASSES = 3
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def full_float32() -> None:
    """float32 convolutions and products in full float32, not TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _pad(kernel, padding):
    if padding == "VALID":
        return (0, 0)
    return (kernel[0] // 2, kernel[1] // 2)


def _avg3(x):
    """The 3x3 stride-1 average pool with its padded zeros counted
    (flax's SAME avg_pool), as a depthwise conv: the backward of torch's
    own avg_pool2d on a card is wrong for channels_last input (torch
    2.11, H100), and a conv's is not."""
    c = x.shape[1]
    kernel = torch.full((c, 1, 3, 3), 1.0 / 9.0, dtype=x.dtype,
                        device=x.device)
    return F.conv2d(x, kernel, None, 1, 1, 1, c)


def _max3(x):
    return F.max_pool2d(x, 3, stride=2)


def _block_a(op, n, x, pool_features):
    b1 = op(f"{n}.b1x1", x, 64, (1, 1))
    b5 = op(f"{n}.b5x5_2", op(f"{n}.b5x5_1", x, 48, (1, 1)), 64, (5, 5))
    b3 = op(f"{n}.b3x3dbl_1", x, 64, (1, 1))
    b3 = op(f"{n}.b3x3dbl_3", op(f"{n}.b3x3dbl_2", b3, 96, (3, 3)), 96,
            (3, 3))
    bp = op(f"{n}.bpool", _avg3(x), pool_features, (1, 1))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _reduction_a(op, n, x):
    b3 = op(f"{n}.b3x3", x, 384, (3, 3), 2, "VALID")
    bd = op(f"{n}.b3x3dbl_1", x, 64, (1, 1))
    bd = op(f"{n}.b3x3dbl_2", bd, 96, (3, 3))
    bd = op(f"{n}.b3x3dbl_3", bd, 96, (3, 3), 2, "VALID")
    return torch.cat([b3, bd, _max3(x)], dim=1)


def _block_b(op, n, x, c7):
    b1 = op(f"{n}.b1x1", x, 192, (1, 1))
    b7 = op(f"{n}.b7x7_1", x, c7, (1, 1))
    b7 = op(f"{n}.b7x7_3", op(f"{n}.b7x7_2", b7, c7, (1, 7)), 192, (7, 1))
    bd = op(f"{n}.b7x7dbl_1", x, c7, (1, 1))
    bd = op(f"{n}.b7x7dbl_3", op(f"{n}.b7x7dbl_2", bd, c7, (7, 1)), c7,
            (1, 7))
    bd = op(f"{n}.b7x7dbl_5", op(f"{n}.b7x7dbl_4", bd, c7, (7, 1)), 192,
            (1, 7))
    bp = op(f"{n}.bpool", _avg3(x), 192, (1, 1))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _reduction_b(op, n, x):
    b3 = op(f"{n}.b3x3_2", op(f"{n}.b3x3_1", x, 192, (1, 1)), 320, (3, 3),
            2, "VALID")
    b7 = op(f"{n}.b7x7x3_1", x, 192, (1, 1))
    b7 = op(f"{n}.b7x7x3_2", b7, 192, (1, 7))
    b7 = op(f"{n}.b7x7x3_3", b7, 192, (7, 1))
    b7 = op(f"{n}.b7x7x3_4", b7, 192, (3, 3), 2, "VALID")
    return torch.cat([b3, b7, _max3(x)], dim=1)


def _block_c(op, n, x):
    b1 = op(f"{n}.b1x1", x, 320, (1, 1))
    b3 = op(f"{n}.b3x3_1", x, 384, (1, 1))
    b3 = torch.cat([op(f"{n}.b3x3_2a", b3, 384, (1, 3)),
                    op(f"{n}.b3x3_2b", b3, 384, (3, 1))], dim=1)
    bd = op(f"{n}.b3x3dbl_2", op(f"{n}.b3x3dbl_1", x, 448, (1, 1)), 384,
            (3, 3))
    bd = torch.cat([op(f"{n}.b3x3dbl_3a", bd, 384, (1, 3)),
                    op(f"{n}.b3x3dbl_3b", bd, 384, (3, 1))], dim=1)
    bp = op(f"{n}.bpool", _avg3(x), 192, (1, 1))
    return torch.cat([b1, b3, bd, bp], dim=1)


def _network(op, x):
    """(B, C, H, W) -> (B, 2048) pooled features. `op(name, x, out,
    kernel, stride=1, padding='SAME')` is one conv + batch norm + ReLU."""
    x = op("stem1", x, 32, (3, 3), 2, "VALID")
    x = op("stem2", x, 32, (3, 3), 1, "VALID")
    x = op("stem3", x, 64, (3, 3))
    x = _max3(x)
    x = op("stem4", x, 80, (1, 1), 1, "VALID")
    x = op("stem5", x, 192, (3, 3), 1, "VALID")
    x = _max3(x)
    for i, pool in enumerate((32, 64, 64)):
        x = _block_a(op, f"mixed{i}", x, pool)
    x = _reduction_a(op, "mixed3", x)
    for i, c7 in zip(range(4, 8), (128, 160, 160, 192)):
        x = _block_b(op, f"mixed{i}", x, c7)
    x = _reduction_b(op, "mixed8", x)
    x = _block_c(op, "mixed9", x)
    x = _block_c(op, "mixed10", x)
    return x.mean(dim=(2, 3))


class _Walk:
    """The network on the meta device: parameter shapes and the
    multiply-adds of every conv."""

    def __init__(self):
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self.flops = 0.0

    def __call__(self, name, x, out, kernel, stride=1, padding="SAME"):
        cin = x.shape[1]
        w = torch.empty((out, cin) + tuple(kernel), device="meta")
        y = F.conv2d(x, w, None, stride, _pad(kernel, padding))
        self.flops += 2.0 * y.numel() * cin * kernel[0] * kernel[1]
        self.shapes[f"{name}.conv.weight"] = tuple(w.shape)
        for leaf in ("bn.bias", "bn.mean", "bn.var"):
            self.shapes[f"{name}.{leaf}"] = (out,)
        return y


def _walk(shape) -> _Walk:
    h, w, c = shape
    walk = _Walk()
    pooled = _network(walk, torch.empty((1, c, h, w), device="meta"))
    walk.shapes["classification.weight"] = (NUM_CLASSES, pooled.shape[1])
    walk.shapes["classification.bias"] = (NUM_CLASSES,)
    walk.flops += 2.0 * NUM_CLASSES * pooled.shape[1]
    return walk


def param_shapes(shape) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of every weight and batch-norm statistic for (H, W,
    C) pileups, in the network's order."""
    return _walk(shape).shapes


def forward_flops(shape) -> float:
    """2 x the multiply-adds of every conv and of the head for one (H,
    W, C) example."""
    return _walk(shape).flops


def is_statistic(name: str) -> bool:
    """Batch-norm running statistics: state, not trained parameters."""
    return name.endswith(".bn.mean") or name.endswith(".bn.var")


def is_kernel(name: str) -> bool:
    """Conv and dense kernels: the leaves under the L2 penalty."""
    return name.endswith("weight")


def _scaled_round(x, dtype, top):
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    if dtype == torch.int8:
        return torch.round(x / scale).clamp(-top, top) * scale
    return (x / scale).to(dtype).to(x.dtype) * scale


# (forward dtype, its largest value, backward dtype, its largest value)
QUANT = {"fp8": (torch.float8_e4m3fn, E4M3_MAX, torch.float8_e5m2,
                 E5M2_MAX),
         "int8": (torch.int8, 127.0, torch.int8, 127.0)}


class _Round(torch.autograd.Function):
    """Forward: x rounded to `dtype` with a per-tensor scale. Backward:
    the incoming gradient passed straight through."""

    @staticmethod
    def forward(ctx, x, dtype, top):
        return _scaled_round(x, dtype, top)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _RoundGrad(torch.autograd.Function):
    """Forward: identity. Backward: the gradient rounded to `dtype` with
    a per-tensor scale."""

    @staticmethod
    def forward(ctx, x, dtype, top):
        ctx.dtype, ctx.top = dtype, top
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _scaled_round(grad, ctx.dtype, ctx.top), None, None


class _Run:
    """conv + batch norm + ReLU over the weights `w`, in inference or
    training mode; in training mode the batch's statistics move the
    running averages into `new_stats` as flax does."""

    def __init__(self, w, training, quant, bn_momentum):
        self.w = w
        self.training = training
        self.quant = QUANT[quant] if quant else None
        self.momentum = bn_momentum
        self.new_stats: Dict[str, torch.Tensor] = {}

    def q(self, x):
        if self.quant is None:
            return x
        fwd, fwd_top, bwd, bwd_top = self.quant
        x = _Round.apply(x, fwd, fwd_top)
        return _RoundGrad.apply(x, bwd, bwd_top) if self.training else x

    def __call__(self, name, x, out, kernel, stride=1, padding="SAME"):
        w = self.w
        y = F.conv2d(self.q(x), self.q(w[f"{name}.conv.weight"]), None,
                     stride, _pad(kernel, padding))
        bias = w[f"{name}.bn.bias"].view(1, -1, 1, 1)
        if self.training:
            mean = y.mean(dim=(0, 2, 3))
            var = (y - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
            with torch.no_grad():
                fast_var = torch.clamp_min(
                    y.square().mean(dim=(0, 2, 3)) - mean.square(), 0.0)
                m = self.momentum
                self.new_stats[f"{name}.bn.mean"] = (
                    m * w[f"{name}.bn.mean"] + (1 - m) * mean)
                self.new_stats[f"{name}.bn.var"] = (
                    m * w[f"{name}.bn.var"] + (1 - m) * fast_var)
        else:
            mean, var = w[f"{name}.bn.mean"], w[f"{name}.bn.var"]
        y = (y - mean.view(1, -1, 1, 1)) * torch.rsqrt(
            var.view(1, -1, 1, 1) + BN_EPSILON) + bias
        return F.relu(y)


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, C, H, W) float32 in [-1, 1): (x - 128) /
    128, DeepVariant's input scaling."""
    x = (images_u8.to(torch.float32) - 128.0) / 128.0
    return x.permute(0, 3, 1, 2).contiguous()


def logits(w: Dict[str, torch.Tensor], images_u8: torch.Tensor,
           training: bool = False, quant: Optional[str] = None,
           keep_mask: Optional[torch.Tensor] = None, dropout_rate=0.2,
           bn_momentum: float = 0.9997):
    """(B, H, W, C) uint8 pileups -> ((B, 3) float32 logits, the moved
    batch-norm statistics in training mode, else {}). `keep_mask` (B,
    2048) bool is the dropout mask of training mode (None: no dropout);
    `quant` ('fp8', 'int8') computes the control."""
    run = _Run(w, training, quant, bn_momentum)
    h = _network(run, normalize(images_u8))
    if training and keep_mask is not None:
        keep = 1.0 - dropout_rate
        h = torch.where(keep_mask, h / keep, torch.zeros_like(h))
    out = F.linear(run.q(h), run.q(w["classification.weight"]),
                   w["classification.bias"])
    return out, run.new_stats


def probabilities(w, images_u8, quant: Optional[str] = None,
                  block: int = 256) -> torch.Tensor:
    """Inference: (B, H, W, C) uint8 -> (B, 3) float32 probabilities,
    computed `block` rows at a time."""
    outs = []
    with torch.no_grad():
        for i in range(0, images_u8.shape[0], block):
            z, _ = logits(w, images_u8[i:i + block], quant=quant)
            outs.append(torch.softmax(z, dim=-1))
    return torch.cat(outs) if outs else torch.zeros((0, NUM_CLASSES))

