"""NHWC ResNet (counterpart of ``apex_tpu/models/resnet.py``): the imagenet
example's ResNet-18 / ResNet-50 as ``nn.Module``s whose parameter names
follow flax's tree (``conv_init``, ``bn_init``, ``BottleneckBlock_3``,
``Conv_1``, ``SyncBatchNorm_2``, ``proj_conv``, ``proj_bn``,
``Dense_0``), so amp's norm predicate keeps the same BN leaves fp32 and
``convert.module_from_numpy`` carries a flax tree (params and
``batch_stats``) across. NHWC in and out; every conv is lax ``"SAME"``
(``models.layers``); the norm is :class:`SyncBatchNorm` (``make_norm``:
local statistics, or across a mesh axis on the current mesh). The convolutions
and the head are cuDNN / cuBLAS calls, as JAX leaves them to XLA: no TPU
kernel of the JAX package runs here.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.models.layers import Conv, Dense, max_pool_same
from apex_tpu_torch.parallel.sync_batchnorm import DP_AXIS, SyncBatchNorm


def make_norm(sync_bn: bool = False, axis_name: str = "dp",
              momentum: float = 0.1, eps: float = 1e-5):
    """JAX's norm factory: :class:`SyncBatchNorm` across ``axis_name`` (on
    the current mesh) or this device's batch."""
    return functools.partial(SyncBatchNorm, momentum=momentum, eps=eps,
                             axis_name=axis_name if sync_bn else None)


class _Block(nn.Module):
    """Numbering flax gives a module's unnamed children: ``Conv_0``,
    ``Conv_1``, ... and ``<norm class>_0``, ... in call order."""

    def _add(self, kind: str, module: nn.Module, name: Optional[str] = None
             ) -> nn.Module:
        if name is None:
            n = self._counts.get(kind, 0)
            self._counts[kind] = n + 1
            name = f"{kind}_{n}"
        self.add_module(name, module)
        return module


def _norm_name(norm: Callable) -> str:
    cls = norm.func if isinstance(norm, functools.partial) else norm
    return cls.__name__


class BottleneckBlock(_Block):
    """1x1 -> 3x3 (strided) -> 1x1, a projection shortcut where the shape
    changes."""

    expansion = 4   # output channels per unit of ``features``

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int] = (1, 1),
                 norm: Callable = SyncBatchNorm,
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._counts = {}
        kw = dict(use_bias=False, dtype=dtype, device=device,
                  generator=generator)
        nn_name = _norm_name(norm)
        self.convs = [
            self._add("Conv", Conv(in_features, features, (1, 1), **kw)),
            self._add("Conv", Conv(features, features, (3, 3), strides,
                                   **kw)),
            self._add("Conv", Conv(features, features * 4, (1, 1), **kw))]
        self.norms = [self._add(nn_name, norm(f, device=device))
                      for f in (features, features, features * 4)]
        self.proj = (in_features != features * 4 or tuple(strides) != (1, 1))
        if self.proj:
            self._add("Conv", Conv(in_features, features * 4, (1, 1), strides,
                                   **kw), "proj_conv")
            self._add(nn_name, norm(features * 4, device=device), "proj_bn")

    def forward(self, x, use_running_average: bool = False):
        y = x
        for i, (conv, bn) in enumerate(zip(self.convs, self.norms)):
            y = bn(conv(y), use_running_average)
            if i < 2:
                y = torch.relu(y)
        residual = x
        if self.proj:
            residual = self.proj_bn(self.proj_conv(x), use_running_average)
        return torch.relu(y + residual)


class BasicBlock(_Block):
    """3x3 (strided) -> 3x3, a projection shortcut where the shape
    changes."""

    expansion = 1

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int] = (1, 1),
                 norm: Callable = SyncBatchNorm,
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._counts = {}
        kw = dict(use_bias=False, dtype=dtype, device=device,
                  generator=generator)
        nn_name = _norm_name(norm)
        self.convs = [
            self._add("Conv", Conv(in_features, features, (3, 3), strides,
                                   **kw)),
            self._add("Conv", Conv(features, features, (3, 3), **kw))]
        self.norms = [self._add(nn_name, norm(features, device=device))
                      for _ in range(2)]
        self.proj = in_features != features or tuple(strides) != (1, 1)
        if self.proj:
            self._add("Conv", Conv(in_features, features, (1, 1), strides,
                                   **kw), "proj_conv")
            self._add(nn_name, norm(features, device=device), "proj_bn")

    def forward(self, x, use_running_average: bool = False):
        y = torch.relu(self.norms[0](self.convs[0](x), use_running_average))
        y = self.norms[1](self.convs[1](y), use_running_average)
        residual = x
        if self.proj:
            residual = self.proj_bn(self.proj_conv(x), use_running_average)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """NHWC ResNet: a 7x7/2 stem conv, its norm, relu, a 3x3/2 max pool,
    the stages, a global mean and the fp32 head. ``x`` (b, h, w, 3) ->
    logits (b, num_classes) fp32. ``dtype``: the convs' compute type
    (flax's ``dtype``; ``None`` follows the inputs and params)."""

    def __init__(self, stage_sizes: Sequence[int],
                 block: type = BottleneckBlock, num_classes: int = 1000,
                 width: int = 64, norm: Callable = SyncBatchNorm,
                 dtype: Optional[torch.dtype] = None, in_features: int = 3,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.conv_init = Conv(in_features, width, (7, 7), (2, 2),
                              use_bias=False, dtype=dtype, device=dev,
                              generator=gen)
        self.bn_init = norm(width, device=dev)
        feats, n = width, 0
        self.blocks = []
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                b = block(feats, width * 2 ** i, strides=strides, norm=norm,
                          dtype=dtype, device=dev, generator=gen)
                self.add_module(f"{block.__name__}_{n}", b)
                self.blocks.append(b)
                feats, n = width * 2 ** i * block.expansion, n + 1
        self.Dense_0 = Dense(feats, num_classes, dtype=torch.float32,
                             device=dev, generator=gen)

    def forward(self, x, use_running_average: bool = False):
        x = torch.relu(self.bn_init(self.conv_init(x), use_running_average))
        x = max_pool_same(x, 3, 2)
        for b in self.blocks:
            x = b(x, use_running_average)
        x = x.mean(dim=(1, 2)).float()
        return self.Dense_0(x)


ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                             block=BottleneckBlock)
ResNet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2),
                             block=BasicBlock)

__all__ = ["ResNet", "ResNet18", "ResNet50", "BottleneckBlock", "BasicBlock",
           "make_norm", "DP_AXIS"]
