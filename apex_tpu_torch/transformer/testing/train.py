"""The flagship training step (counterpart of ``bench.py``'s
``build_train_step``, ``bench.py:55-102``): forward with full remat,
backward and the FusedAdam update of a GPT on one device.

    cfg = GPTConfig()        # bf16, full remat, fused LM-head loss
    step, params, opt, tok, tgt = build_train_step(cfg, 8, 1024)
    loss = step()            # 0-d fp32 tensor, no host sync inside

Parameters come from :func:`init_gpt_params` (numpy seed ``seed``),
tokens from ``numpy.random.default_rng(seed + 1)``, and ``tgt`` is
``tok`` rolled by one position, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.convert import named_leaves
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    GPTConfig,
    gpt_loss,
    init_gpt_params,
)


def param_leaves(params: Dict[str, Any]):
    """The tensors of a nested param dict, in the JAX tree order."""
    return [t for _, t in named_leaves(params)]


def build_train_step(cfg: GPTConfig, batch: int, seq: int,
                     device: DeviceLike = None, seed: int = 0,
                     fused_tail: str = "auto"
                     ) -> Tuple[Callable[[], torch.Tensor], Dict[str, Any],
                                FusedAdam, torch.Tensor, torch.Tensor]:
    """Returns ``(train_step, params, optimizer, tok, tgt)``; each call of
    ``train_step()`` runs one fwd + bwd + ``FusedAdam(lr=1e-4,
    fused_tail=fused_tail)`` update on the fixed batch and returns the
    loss before the update (a 0-d tensor on the device). The defaults are
    JAX's: the loss follows ``cfg.fused_loss`` and the Adam tail is one
    kernel per leaf (``"auto"``); ``fused_tail="off"`` keeps the op
    chain."""
    cfg.validate()
    if seq > cfg.max_seq:
        raise ValueError(f"seq ({seq}) exceeds max_seq ({cfg.max_seq})")
    dev = resolve_device(device)
    params = init_gpt_params(cfg, seed=seed, device=dev)
    for p in param_leaves(params):
        p.requires_grad_(True)
    optimizer = FusedAdam(param_leaves(params), lr=1e-4,
                          fused_tail=fused_tail)
    rng = np.random.default_rng(seed + 1)
    tok = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    ).to(dev)
    tgt = torch.roll(tok, -1, dims=1)

    def train_step() -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = gpt_loss(params, tok, tgt, cfg)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step, params, optimizer, tok, tgt
