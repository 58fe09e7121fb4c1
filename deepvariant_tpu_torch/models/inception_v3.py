"""Inception-v3 genotype classifier in PyTorch.

Counterpart of `deepvariant_tpu/models/inception_v3.py` (the reference's
keras_modeling.py:246-307: an InceptionV3 backbone with pooling='avg', a
0.2 dropout and a 3-class softmax head). Same branch widths, batch norm
without scale and with epsilon 1e-3, and the same parameter names, so
`from_flax_variables` and `to_flax_variables` move weights between the
two packages tensor by tensor.

Public functions keep the JAX layout: the model takes NHWC input and
returns (B, 3) float32 probabilities. Inside, the activations are NCHW
tensors in channels_last memory, which is the NHWC layout cuDNN's fast
convolutions read. Convolutions go to cuDNN through `F.conv2d`, as the
JAX package left them to XLA.

On the card the convolutions run in bfloat16 while batch-norm statistics
and the classifier head stay float32, as in the JAX model. The model's
`dtype` is its compute dtype, as flax's `dtype` field is: each conv casts
its weight and input to it per call, so a model trained from float32
master weights computes in bfloat16 as flax's `dtype=bfloat16` does,
and `prepare_for_inference` casts the conv weights once instead.

`module.train()` selects training mode: batch norm normalizes with the
batch's statistics and moves its running averages the flax way, and the
head's dropout draws from the `generator` passed to `forward`.

The inference-graph rewrites of the JAX package are here too, model in,
model out: `fold_batch_norm`, `pad_stem_input_channels`,
`convert_stem_to_s2d` (the stride-2 3x3 stem as space-to-depth + a 2x2
stride-1 conv, exact) and `adapt_input_channels` (the stem for another
channel count, as keras_modeling.py:113-169 does it).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepvariant_tpu_torch.device import resolve_device
from deepvariant_tpu_torch.ops import batch_norm_relu, pool

NUM_CLASSES = 3  # {hom-ref, het, hom-alt} (reference dv_constants.py:77)
DEFAULT_BACKBONE_DROPOUT_RATE = 0.2  # keras_modeling.py:43
BN_EPSILON = 1e-3


class BatchNorm(nn.Module):
    """Batch norm with `use_scale=False`: a learned bias and the running
    mean and variance (flax names `bias`, `mean`, `var`).

    In training mode it normalizes with the batch's biased variance and
    moves the running averages as flax does: the statistics reduced in
    float32 with the fast variance E[x^2] - E[x]^2 (clipped at 0), and
    `ra = momentum * ra + (1 - momentum) * batch`. torch's own running
    update takes the unbiased variance and the other momentum, so it is
    not used: the running tensors are written here, in place.
    `forward(x, relu=True)`, which ConvBN calls, also takes the ReLU; in
    training mode on one device that is the one op
    `ops.batch_norm_relu` (the hand-written kernels on the card).

    Under data parallelism (`sync_batch_norm`) the statistics are the
    global batch's: each rank's count, per-channel mean and sum of
    squared deviations are gathered from every rank by
    `gather_over_ranks` (which autograd differentiates) and combined
    (Chan et al.'s pairwise update), and the layer normalizes with the
    global mean and that variance, which is the stable form
    torch.batch_norm takes on one device; the running variance moves by
    flax's fast E[x^2] - E[x]^2 of the same global batch, as on one
    device. One collective per layer forward and one backward."""

    def __init__(self, features: int, momentum: float = 0.9997):
        super().__init__()
        self.momentum = momentum
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.gather_over_ranks: Optional[Callable] = None

    def _update_running(self, mean, var):
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)

    def _forward_synced(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=xf.dtype,
                           device=x.device)
        local_mean = xf.mean(dim=(0, 2, 3))
        local_m2 = (xf - local_mean.view(1, c, 1, 1)).square().sum(
            dim=(0, 2, 3))
        rows = self.gather_over_ranks(torch.cat([count, local_mean,
                                                 local_m2]))
        counts, means, m2s = rows[:, :1], rows[:, 1:c + 1], rows[:, c + 1:]
        total = counts.sum()
        mean = (means * (counts / total)).sum(dim=0)
        m2 = (m2s + counts * (means - mean).square()).sum(dim=0)
        var = m2 / total
        with torch.no_grad():
            square_mean = ((m2s + counts * means.square()).sum(dim=0)
                           / total)
            self._update_running(
                mean, torch.clamp_min(square_mean - mean.square(), 0.0))
        scale = torch.rsqrt(var + BN_EPSILON)
        y = (xf - mean.view(1, c, 1, 1)) * scale.view(1, c, 1, 1) \
            + self.bias.view(1, c, 1, 1)
        return y.to(x.dtype)

    def forward(self, x, relu: bool = False):
        if not self.training:
            y = F.batch_norm(x, self.mean, self.var, None, self.bias,
                             False, 0.0, BN_EPSILON)
        elif self.gather_over_ranks is not None:
            y = self._forward_synced(x)
        elif relu:
            return batch_norm_relu.batch_norm_relu(
                x, self.bias, self.mean, self.var, self.momentum,
                BN_EPSILON)
        else:
            y = batch_norm_relu.batch_norm_train_reference(
                x, self.bias, self.mean, self.var, self.momentum,
                BN_EPSILON)
        return F.relu(y) if relu else y


@contextlib.contextmanager
def sync_batch_norm(model: nn.Module, gather_over_ranks: Optional[Callable]):
    """Every BatchNorm of `model` takes its training statistics over the
    ranks while the block runs: `gather_over_ranks(t)` returns every
    rank's `t` stacked, in rank order (None: the local batch's)."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for layer in layers:
        layer.gather_over_ranks = gather_over_ranks
    try:
        yield
    finally:
        for layer in layers:
            layer.gather_over_ranks = None


class ConvBN(nn.Module):
    """Conv2D(use_bias=False) + BatchNorm(scale=False, eps=1e-3) + ReLU, or
    Conv2D with bias + ReLU once batch norm is folded into the conv."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Tuple[int, int], stride: int = 1,
                 padding: str = "SAME", fold_bn: bool = False):
        super().__init__()
        if padding == "SAME":
            # Every SAME conv of the network has stride 1 and odd kernels,
            # where SAME pads symmetrically.
            if stride != 1 or kernel[0] % 2 == 0 or kernel[1] % 2 == 0:
                raise ValueError("SAME padding needs stride 1, odd kernels")
            pad = (kernel[0] // 2, kernel[1] // 2)
        elif padding == "VALID":
            pad = (0, 0)
        else:
            raise ValueError(f"unknown padding {padding!r}")
        self.conv = nn.Conv2d(in_channels, features, kernel, stride, pad,
                              bias=fold_bn)
        self.bn = None if fold_bn else BatchNorm(features)

    def forward(self, x):
        # The weight in the input's dtype (a no-op once
        # prepare_for_inference has cast it), as flax promotes both.
        conv = self.conv
        bias = None if conv.bias is None else conv.bias.to(x.dtype)
        x = conv._conv_forward(x, conv.weight.to(x.dtype), bias)
        if self.bn is None:
            return F.relu(x)
        return self.bn(x, relu=True)


def _space_to_depth_2x2(x):
    """(B, H, W, C) -> (B, H/2, W/2, 4C), zero-padding odd H/W.

    Channel packing: index ((p*2 + q)*C + c) for in-block offset
    (p, q), the JAX package's order, so a 2x2 stem kernel carried across
    from it (kh, kw, 4C, cout) fits as it is.
    """
    b, h, w, c = x.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        h, w = h + ph, w + pw
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def _avg_pool_same(x):
    # flax avg_pool counts the padded zeros, as count_include_pad does.
    return pool.box3x3(x)


def _max_pool_v(x):
    return pool.max3x3s2(x)


class InceptionA(nn.Module):
    """35x35-grid block (keras mixed0/1/2): 1x1, 5x5, double-3x3, pool."""

    def __init__(self, in_channels: int, pool_features: int,
                 fold_bn: bool = False):
        super().__init__()
        c, f = in_channels, fold_bn
        self.b1x1 = ConvBN(c, 64, (1, 1), fold_bn=f)
        self.b5x5_1 = ConvBN(c, 48, (1, 1), fold_bn=f)
        self.b5x5_2 = ConvBN(48, 64, (5, 5), fold_bn=f)
        self.b3x3dbl_1 = ConvBN(c, 64, (1, 1), fold_bn=f)
        self.b3x3dbl_2 = ConvBN(64, 96, (3, 3), fold_bn=f)
        self.b3x3dbl_3 = ConvBN(96, 96, (3, 3), fold_bn=f)
        self.bpool = ConvBN(c, pool_features, (1, 1), fold_bn=f)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b1 = self.b1x1(x)
        b5 = self.b5x5_2(self.b5x5_1(x))
        b3 = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        bp = self.bpool(_avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class ReductionA(nn.Module):
    """Grid reduction 35->17 (keras mixed3)."""

    def __init__(self, in_channels: int, fold_bn: bool = False):
        super().__init__()
        c, f = in_channels, fold_bn
        self.b3x3 = ConvBN(c, 384, (3, 3), 2, "VALID", fold_bn=f)
        self.b3x3dbl_1 = ConvBN(c, 64, (1, 1), fold_bn=f)
        self.b3x3dbl_2 = ConvBN(64, 96, (3, 3), fold_bn=f)
        self.b3x3dbl_3 = ConvBN(96, 96, (3, 3), 2, "VALID", fold_bn=f)
        self.out_channels = 384 + 96 + c

    def forward(self, x):
        b3 = self.b3x3(x)
        bd = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool_v(x)], dim=1)


class InceptionB(nn.Module):
    """17x17-grid block with factorized 7x7 convs (keras mixed4-7)."""

    def __init__(self, in_channels: int, c7: int, fold_bn: bool = False):
        super().__init__()
        c, f = in_channels, fold_bn
        self.b1x1 = ConvBN(c, 192, (1, 1), fold_bn=f)
        self.b7x7_1 = ConvBN(c, c7, (1, 1), fold_bn=f)
        self.b7x7_2 = ConvBN(c7, c7, (1, 7), fold_bn=f)
        self.b7x7_3 = ConvBN(c7, 192, (7, 1), fold_bn=f)
        self.b7x7dbl_1 = ConvBN(c, c7, (1, 1), fold_bn=f)
        self.b7x7dbl_2 = ConvBN(c7, c7, (7, 1), fold_bn=f)
        self.b7x7dbl_3 = ConvBN(c7, c7, (1, 7), fold_bn=f)
        self.b7x7dbl_4 = ConvBN(c7, c7, (7, 1), fold_bn=f)
        self.b7x7dbl_5 = ConvBN(c7, 192, (1, 7), fold_bn=f)
        self.bpool = ConvBN(c, 192, (1, 1), fold_bn=f)
        self.out_channels = 4 * 192

    def forward(self, x):
        b1 = self.b1x1(x)
        b7 = self.b7x7_3(self.b7x7_2(self.b7x7_1(x)))
        bd = self.b7x7dbl_1(x)
        bd = self.b7x7dbl_3(self.b7x7dbl_2(bd))
        bd = self.b7x7dbl_5(self.b7x7dbl_4(bd))
        bp = self.bpool(_avg_pool_same(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class ReductionB(nn.Module):
    """Grid reduction 17->8 (keras mixed8)."""

    def __init__(self, in_channels: int, fold_bn: bool = False):
        super().__init__()
        c, f = in_channels, fold_bn
        self.b3x3_1 = ConvBN(c, 192, (1, 1), fold_bn=f)
        self.b3x3_2 = ConvBN(192, 320, (3, 3), 2, "VALID", fold_bn=f)
        self.b7x7x3_1 = ConvBN(c, 192, (1, 1), fold_bn=f)
        self.b7x7x3_2 = ConvBN(192, 192, (1, 7), fold_bn=f)
        self.b7x7x3_3 = ConvBN(192, 192, (7, 1), fold_bn=f)
        self.b7x7x3_4 = ConvBN(192, 192, (3, 3), 2, "VALID", fold_bn=f)
        self.out_channels = 320 + 192 + c

    def forward(self, x):
        b3 = self.b3x3_2(self.b3x3_1(x))
        b7 = self.b7x7x3_2(self.b7x7x3_1(x))
        b7 = self.b7x7x3_4(self.b7x7x3_3(b7))
        return torch.cat([b3, b7, _max_pool_v(x)], dim=1)


class InceptionC(nn.Module):
    """8x8-grid block with expanded filter banks (keras mixed9/10)."""

    def __init__(self, in_channels: int, fold_bn: bool = False):
        super().__init__()
        c, f = in_channels, fold_bn
        self.b1x1 = ConvBN(c, 320, (1, 1), fold_bn=f)
        self.b3x3_1 = ConvBN(c, 384, (1, 1), fold_bn=f)
        self.b3x3_2a = ConvBN(384, 384, (1, 3), fold_bn=f)
        self.b3x3_2b = ConvBN(384, 384, (3, 1), fold_bn=f)
        self.b3x3dbl_1 = ConvBN(c, 448, (1, 1), fold_bn=f)
        self.b3x3dbl_2 = ConvBN(448, 384, (3, 3), fold_bn=f)
        self.b3x3dbl_3a = ConvBN(384, 384, (1, 3), fold_bn=f)
        self.b3x3dbl_3b = ConvBN(384, 384, (3, 1), fold_bn=f)
        self.bpool = ConvBN(c, 192, (1, 1), fold_bn=f)
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x):
        b1 = self.b1x1(x)
        b3 = self.b3x3_1(x)
        b3 = torch.cat([self.b3x3_2a(b3), self.b3x3_2b(b3)], dim=1)
        bd = self.b3x3dbl_2(self.b3x3dbl_1(x))
        bd = torch.cat([self.b3x3dbl_3a(bd), self.b3x3dbl_3b(bd)], dim=1)
        bp = self.bpool(_avg_pool_same(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """InceptionV3 backbone + avg-pool + dropout + 3-class head.

    `forward` takes (B, H, W, C) NHWC input, normalized as
    `normalize_pileup` does, and returns (B, 3) float32 probabilities;
    `logits` returns the head's float32 logits. `dtype` is the compute
    dtype of the convs; `bn_momentum` is every batch norm's running-
    average momentum (keras InceptionV3's 0.9997 by default). With
    `stem_s2d` the stem takes the 2x2 space-to-depth input through a 2x2
    stride-1 conv (`convert_stem_to_s2d` makes its weights)."""

    def __init__(self, num_channels: int, num_classes: int = NUM_CLASSES,
                 fold_bn: bool = False,
                 dropout_rate: float = DEFAULT_BACKBONE_DROPOUT_RATE,
                 bn_momentum: float = 0.9997,
                 dtype: torch.dtype = torch.float32,
                 stem_s2d: bool = False):
        super().__init__()
        self.num_channels = num_channels
        self.num_classes = num_classes
        self.fold_bn = fold_bn
        self.dropout_rate = dropout_rate
        self.bn_momentum = bn_momentum
        self.dtype = dtype
        self.stem_s2d = stem_s2d
        f = fold_bn
        if stem_s2d:
            self.stem1 = ConvBN(4 * num_channels, 32, (2, 2), 1, "VALID",
                                fold_bn=f)
        else:
            self.stem1 = ConvBN(num_channels, 32, (3, 3), 2, "VALID",
                                fold_bn=f)
        self.stem2 = ConvBN(32, 32, (3, 3), 1, "VALID", fold_bn=f)
        self.stem3 = ConvBN(32, 64, (3, 3), fold_bn=f)
        self.stem4 = ConvBN(64, 80, (1, 1), 1, "VALID", fold_bn=f)
        self.stem5 = ConvBN(80, 192, (3, 3), 1, "VALID", fold_bn=f)
        blocks = []
        c = 192
        for name, make in [
            ("mixed0", lambda c: InceptionA(c, 32, f)),
            ("mixed1", lambda c: InceptionA(c, 64, f)),
            ("mixed2", lambda c: InceptionA(c, 64, f)),
            ("mixed3", lambda c: ReductionA(c, f)),
            ("mixed4", lambda c: InceptionB(c, 128, f)),
            ("mixed5", lambda c: InceptionB(c, 160, f)),
            ("mixed6", lambda c: InceptionB(c, 160, f)),
            ("mixed7", lambda c: InceptionB(c, 192, f)),
            ("mixed8", lambda c: ReductionB(c, f)),
            ("mixed9", lambda c: InceptionC(c, f)),
            ("mixed10", lambda c: InceptionC(c, f)),
        ]:
            block = make(c)
            self.add_module(name, block)
            blocks.append(block)
            c = block.out_channels
        self._blocks = blocks
        self._block_names = [name for name, _ in self.named_children()
                             if name.startswith("mixed")]
        self.classification = nn.Linear(c, num_classes)
        for module in self.modules():
            if isinstance(module, BatchNorm):
                module.momentum = bn_momentum

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dtype

    def backbone(self, x, stop_after: Optional[str] = None):
        """The pooled (B, 2048) float32 features. `stop_after` truncates
        the graph after a named block group ('stem' / 'mixedN') and
        returns that activation, (B, H', W', C') in the input's NHWC
        layout: the per-segment timing hook of the JAX package."""
        x = x.to(self.compute_dtype)
        if self.stem_s2d:
            x = _space_to_depth_2x2(x)
        x = x.permute(0, 3, 1, 2)
        x = self.stem3(self.stem2(self.stem1(x)))
        x = _max_pool_v(x)
        x = self.stem5(self.stem4(x))
        x = _max_pool_v(x)
        if stop_after == "stem":
            return x.permute(0, 2, 3, 1)
        for name, block in zip(self._block_names, self._blocks):
            x = block(x)
            if stop_after == name:
                return x.permute(0, 2, 3, 1)
        # pooling='avg' (keras_modeling.py:252-257). The JAX model takes
        # the mean in the compute dtype, so the pooled features round to
        # it before the float32 head.
        pooled = x.mean(dim=(2, 3), dtype=torch.float32)
        return pooled.to(x.dtype).to(torch.float32)

    def logits(self, x, generator: Optional[torch.Generator] = None):
        h = self.backbone(x)
        if self.training and self.dropout_rate > 0:
            h = dropout(h, self.dropout_rate, generator)
        # fp32 head, L2-regularized in the training loss
        # (keras_modeling.py:46-68).
        return self.classification(h)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return torch.softmax(self.logits(x, generator), dim=-1)


def dropout(h: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's `nn.Dropout`: keep each element with probability 1 - rate
    and scale the kept ones by 1 / (1 - rate). The mask is drawn from
    `generator` (torch's default generator when None); torch cannot draw
    JAX's masks, so the train step seeds a generator per step instead."""
    keep_prob = 1.0 - rate
    keep = torch.rand(h.shape, generator=generator, device=h.device,
                      dtype=torch.float32) < keep_prob
    return torch.where(keep, h / keep_prob, torch.zeros_like(h))


def normalize_pileup(images_uint8: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 pileup -> model input: (x - 128) / 128 in `dtype`; exact in
    bfloat16 and float32 alike (reference dv_utils.py:356-380)."""
    return (images_uint8.to(dtype) - 128.0) / 128.0


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal at +-2 std with
    variance 1/fan_in after truncation."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def create_model(
    num_channels: int,
    height: int = 100,
    width: int = 221,
    dtype: torch.dtype = torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    bn_momentum: float = 0.9997,
    device: Union[str, torch.device] = "cuda",
) -> InceptionV3:
    """Build the model for (height, width, num_channels) pileups with
    flax's default initialisation (lecun-normal kernels, zero biases,
    BN mean 0 and variance 1), drawn from `generator` (seed 0 when none
    is given; the JAX package's `rng`), ready for inference on `device`
    in `dtype`. Built with the model's default 0.2 dropout, as the JAX
    package's `create_model` is. The trainer builds it in float32 for
    its master weights and sets the compute dtype itself."""
    if height < 75 or width < 75:
        raise ValueError(f"InceptionV3 needs at least 75x75 input, got "
                         f"{height}x{width}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = InceptionV3(num_channels, bn_momentum=bn_momentum)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                _lecun_normal_(module.weight, fan_in, generator)
                if module.bias is not None:
                    module.bias.zero_()
    return prepare_for_inference(model, device, dtype)


def prepare_for_inference(model: InceptionV3,
                          device: Union[str, torch.device],
                          dtype: torch.dtype) -> InceptionV3:
    """A copy of `model` in eval mode on `device`: conv weights in
    `dtype` and channels_last, batch norm and head in float32."""
    model = copy.deepcopy(model).eval().to(resolve_device(device))
    model.dtype = dtype
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            module.to(dtype=dtype, memory_format=torch.channels_last)
    return model


def fold_batch_norm(model: InceptionV3) -> InceptionV3:
    """Fold every ConvBN's batch norm into its conv (inference only).

    With scale=False batch norm, y = (conv(x) - mean) * s + beta where
    s = 1/sqrt(var + eps): the folded conv has weight * s per output
    channel and bias beta - mean * s, computed in float32 as the JAX
    package's `fold_batch_norm` does; fold float32 weights and cast
    afterwards to match it. Returns a new model on the same device and
    with the same conv dtype."""
    if model.fold_bn:
        return model
    conv_dtype = model.compute_dtype
    device = model.stem1.conv.weight.device
    def f32(t):
        return t.detach().cpu().float().numpy()

    state = {}
    for name, module in model.named_modules():
        if isinstance(module, ConvBN):
            # numpy, as in the JAX package: torch's 1 / sqrt(x) on the
            # CPU does not always round as numpy's does.
            s = 1.0 / np.sqrt(f32(module.bn.var) + BN_EPSILON)
            w = f32(module.conv.weight) * s[:, None, None, None]
            state[f"{name}.conv.weight"] = torch.from_numpy(w)
            state[f"{name}.conv.bias"] = torch.from_numpy(
                f32(module.bn.bias) - f32(module.bn.mean) * s)
    state["classification.weight"] = model.classification.weight.detach()
    state["classification.bias"] = model.classification.bias.detach()
    folded = InceptionV3(model.num_channels, model.num_classes,
                         fold_bn=True, dropout_rate=model.dropout_rate,
                         bn_momentum=model.bn_momentum,
                         stem_s2d=model.stem_s2d)
    folded.load_state_dict({k: v.float().cpu() for k, v in state.items()})
    return prepare_for_inference(folded, device, conv_dtype)


def pad_stem_input_channels(model: InceptionV3,
                            to_channels: int) -> InceptionV3:
    """Zero-pad the stem conv's input channels (the caller pads the images
    to match). Exact: the padded weight slice is zero, so the extra
    channels never contribute. Returns a new model."""
    c = model.num_channels
    if to_channels < c:
        raise ValueError(f"cannot shrink {c} -> {to_channels}")
    if model.stem_s2d:
        raise ValueError("pad the stem before convert_stem_to_s2d")
    weight = torch.zeros_like(model.stem1.conv.weight[:, :1]).repeat(
        1, to_channels, 1, 1)
    weight[:, :c] = model.stem1.conv.weight.detach()
    return _with_stem_weight(model, weight, num_channels=to_channels)


def _with_stem_weight(model: InceptionV3, weight: torch.Tensor,
                      num_channels: int,
                      stem_s2d: Optional[bool] = None) -> InceptionV3:
    """A copy of `model` whose stem conv has `weight` (O, I, kh, kw), the
    stem's stride 1 for a 2x2 kernel, and the same bias."""
    out = copy.deepcopy(model)
    old = model.stem1.conv
    kernel = tuple(weight.shape[2:])
    new = nn.Conv2d(weight.shape[1], old.out_channels, kernel,
                    1 if kernel == (2, 2) else old.stride, old.padding,
                    bias=old.bias is not None)
    new = new.to(device=old.weight.device, dtype=old.weight.dtype,
                 memory_format=torch.channels_last)
    with torch.no_grad():
        new.weight.copy_(weight)
        if old.bias is not None:
            new.bias.copy_(old.bias)
    out.stem1.conv = new
    out.num_channels = num_channels
    if stem_s2d is not None:
        out.stem_s2d = stem_s2d
    return out


def convert_stem_to_s2d(model: InceptionV3) -> InceptionV3:
    """The model with its stem rewritten for the space-to-depth graph.

    Exact: a VALID 3x3 stride-2 conv equals a VALID 4x4 stride-2 conv
    with a zero-padded kernel, which equals a VALID 2x2 stride-1 conv
    over the 2x2 space-to-depth input: K2[o, (p*2+q)*C + c, a, b] =
    K[o, c, 2a+p, 2b+q] (zero where the pad lands), the JAX package's
    packing in torch's (O, I, kh, kw) layout. Works on folded and
    unfolded models (batch norm and the bias attach to output channels,
    which are untouched). Returns a new model."""
    kernel = model.stem1.conv.weight.detach()
    o, c, kh, kw = kernel.shape
    if model.stem_s2d or (kh, kw) != (3, 3):
        raise ValueError(
            f"stem1 kernel is {tuple(kernel.shape)}, expected 3x3")
    k2 = torch.zeros((o, 4 * c, 2, 2), dtype=kernel.dtype,
                     device=kernel.device)
    for a in (0, 1):
        for b in (0, 1):
            for p in (0, 1):
                for q in (0, 1):
                    di, dj = 2 * a + p, 2 * b + q
                    if di < 3 and dj < 3:
                        k2[:, (p * 2 + q) * c:(p * 2 + q + 1) * c, a, b] = \
                            kernel[:, :, di, dj]
    return _with_stem_weight(model, k2, num_channels=c, stem_s2d=True)


def adapt_input_channels(model: InceptionV3, new_num_channels: int,
                         generator: Optional[torch.Generator] = None
                         ) -> InceptionV3:
    """The stem conv re-shaped for another channel count.

    Port of `load_weights_to_model_with_different_channels`
    (keras_modeling.py:113-169): the shared leading channels are
    copied, extra channels are freshly drawn (normal, std
    sqrt(2 / fan_in), fan_in = kh * kw * new_num_channels). The JAX
    package draws them with jax.random.normal; here they come from
    `generator` (seed 0 when none is given), so the new slice matches
    JAX's in distribution only. Returns a new model (the model itself
    when the count is unchanged)."""
    if model.stem_s2d:
        raise ValueError("adapt the stem before convert_stem_to_s2d")
    kernel = model.stem1.conv.weight.detach()
    c_out, c_in, kh, kw = kernel.shape
    if c_in == new_num_channels:
        return model
    if new_num_channels < c_in:
        weight = kernel[:, :new_num_channels]
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        fan_in = kh * kw * new_num_channels
        extra = torch.randn((kh, kw, new_num_channels - c_in, c_out),
                            generator=generator, dtype=torch.float32)
        extra = (extra * (2.0 / fan_in) ** 0.5).permute(3, 2, 0, 1)
        weight = torch.cat([kernel, extra.to(kernel)], dim=1)
    return _with_stem_weight(model, weight, num_channels=new_num_channels)


# ---------------------------------------------------------------------------
# Weights from and to the JAX package's {params, batch_stats} tree
# ---------------------------------------------------------------------------

def _flatten(tree: dict, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def tree_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """A flax tree of arrays (one collection) -> {state-dict name: tensor}:
    conv kernels HWIO -> OIHW, a Dense kernel transposed, every other
    leaf under its own name."""
    state = {}
    for path, value in _flatten(tree):
        arr = np.asarray(value)
        leaf = path[-1]
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            leaf = "weight"
        key = ".".join(path[:-1] + (leaf,))
        state[key] = torch.from_numpy(np.array(arr, order="C"))
    return state


def tree_to_flax(state: Dict[str, torch.Tensor]) -> dict:
    """{state-dict name: tensor} -> the flax tree of float32 numpy arrays
    (the inverse of `tree_from_flax`)."""
    tree: dict = {}
    for name, tensor in state.items():
        path = name.split(".")
        leaf = path[-1]
        arr = tensor.detach().cpu().float().numpy()
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            leaf = "kernel"
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def from_flax_variables(variables: Dict[str, dict]) -> Dict[str, torch.Tensor]:
    """The JAX package's {params, batch_stats} tree of arrays -> a state
    dict for `InceptionV3`: conv kernels HWIO -> OIHW, the Dense kernel
    transposed, BN bias/mean/var under the same names."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    state = {}
    for collection in ("params", "batch_stats"):
        state.update(tree_from_flax(variables.get(collection, {})))
    return state


def to_flax_variables(model: nn.Module) -> Dict[str, dict]:
    """`InceptionV3` weights -> the JAX package's {params, batch_stats}
    tree of float32 numpy arrays (batch_stats omitted once folded)."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    variables = {"params": tree_to_flax(params)}
    if buffers:
        variables["batch_stats"] = tree_to_flax(buffers)
    return variables
