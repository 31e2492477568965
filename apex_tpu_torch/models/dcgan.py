"""DCGAN generator and discriminator (counterpart of
``apex_tpu/models/dcgan.py``; JAX's NHWC versions of the DCGAN example's
netG / netD) as ``nn.Module``s with flax's parameter names
(``ConvTranspose_0``, ``BatchNorm_0``, ``Conv_3``, ...). Their norm is
flax's ``nn.BatchNorm`` (``models.layers.BatchNorm``: decay 0.99, eps
1e-5, a biased running var), not ``SyncBatchNorm``; their transposed
convs are flax's (``models.layers.ConvTranspose``: the kernel flipped
against ``F.conv_transpose2d``'s)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.models.layers import BatchNorm, Conv, ConvTranspose


class Generator(nn.Module):
    """z (B, 1, 1, nz) -> image (B, isize, isize, nc) in [-1, 1]: a 4x4
    VALID transposed conv to 4 x 4, then 4x4/2 SAME ones doubling the size
    (BatchNorm + relu after each but the last), tanh."""

    def __init__(self, isize: int = 64, nz: int = 100, ngf: int = 64,
                 nc: int = 3, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        kw = dict(use_bias=False, dtype=dtype, device=dev, generator=gen)
        mult = isize // 8
        convs = [ConvTranspose(nz, ngf * mult, (4, 4), (1, 1), "VALID", **kw)]
        norms = [BatchNorm(ngf * mult, device=dev)]
        size, feats = 4, ngf * mult
        while size < isize // 2:
            mult //= 2
            convs.append(ConvTranspose(feats, ngf * mult, (4, 4), (2, 2),
                                       "SAME", **kw))
            norms.append(BatchNorm(ngf * mult, device=dev))
            size, feats = size * 2, ngf * mult
        convs.append(ConvTranspose(feats, nc, (4, 4), (2, 2), "SAME", **kw))
        for i, c in enumerate(convs):
            self.add_module(f"ConvTranspose_{i}", c)
        for i, b in enumerate(norms):
            self.add_module(f"BatchNorm_{i}", b)
        self.convs, self.norms = convs, norms

    def forward(self, z, train: bool = True):
        x = z
        for conv, bn in zip(self.convs, self.norms):
            x = torch.relu(bn(conv(x), use_running_average=not train))
        return torch.tanh(self.convs[-1](x))


class Discriminator(nn.Module):
    """image (B, isize, isize, nc) -> logit (B,): 4x4/2 SAME convs halving
    the size (leaky relu 0.2; BatchNorm after all but the first) down to 4
    x 4, then a 4x4 VALID conv to one logit."""

    def __init__(self, isize: int = 64, ndf: int = 64, nc: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        kw = dict(use_bias=False, dtype=dtype, device=dev, generator=gen)
        convs = [Conv(nc, ndf, (4, 4), (2, 2), "SAME", **kw)]
        norms = []
        size, mult = isize // 2, 1
        while size > 4:
            convs.append(Conv(ndf * mult, ndf * mult * 2, (4, 4), (2, 2),
                              "SAME", **kw))
            mult *= 2
            norms.append(BatchNorm(ndf * mult, device=dev))
            size //= 2
        convs.append(Conv(ndf * mult, 1, (4, 4), (1, 1), "VALID", **kw))
        for i, c in enumerate(convs):
            self.add_module(f"Conv_{i}", c)
        for i, b in enumerate(norms):
            self.add_module(f"BatchNorm_{i}", b)
        self.convs, self.norms = convs, norms

    def forward(self, x, train: bool = True):
        x = F.leaky_relu(self.convs[0](x), 0.2)
        for conv, bn in zip(self.convs[1:-1], self.norms):
            x = F.leaky_relu(bn(conv(x), use_running_average=not train), 0.2)
        x = self.convs[-1](x)
        return x.reshape(x.shape[0])
