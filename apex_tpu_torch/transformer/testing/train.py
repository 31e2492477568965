"""The flagship training step (counterpart of ``bench.py``'s
``build_train_step``, ``bench.py:55-102``): forward with full remat,
backward and the FusedAdam update of a GPT on one device; and the same
step for the T5 encoder-decoder (JAX's sequential ``t5_loss``).

    cfg = GPTConfig()        # bf16, full remat, fused LM-head loss
    step, params, opt, tok, tgt = build_train_step(cfg, 8, 1024)
    loss = step()            # 0-d fp32 tensor, no host sync inside

    # GPT-2's published dropout, a fresh threefry key each step
    cfg = GPTConfig(attention_dropout=0.1, hidden_dropout=0.1,
                    remat_policy="dots_attn")
    step = build_train_step(cfg, 8, 1024)[0]
    base = prng_key(0)       # transformer.tensor_parallel.random
    losses = [step(fold_in(base, i)) for i in range(10)]

    cfg = T5Config(relative_position_bias=True, encoder_final_ln=True)
    step, params, opt, (enc, dec, tgt) = build_t5_train_step(cfg, 8, 512,
                                                             128)

Parameters come from :func:`init_gpt_params` / :func:`init_t5_params`
(numpy seed ``seed``), tokens from ``numpy.random.default_rng(seed + 1)``,
and the targets are the (decoder) tokens rolled by one position, as in
JAX.
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
from apex_tpu_torch.transformer.testing.standalone_t5 import (
    T5Config,
    init_t5_params,
    t5_loss,
)


def param_leaves(params: Dict[str, Any]):
    """The tensors of a nested param dict, in the JAX tree order."""
    return [t for _, t in named_leaves(params)]


def build_train_step(cfg: GPTConfig, batch: int, seq: int,
                     device: DeviceLike = None, seed: int = 0,
                     fused_tail: str = "auto", ddp=None, plan=None
                     ) -> Tuple[Callable[[], torch.Tensor], Dict[str, Any],
                                Any, torch.Tensor, torch.Tensor]:
    """Returns ``(train_step, params, optimizer, tok, tgt)``; each call of
    ``train_step(dropout_key=None)`` runs one fwd + bwd +
    ``FusedAdam(lr=1e-4, fused_tail=fused_tail)`` update on the fixed
    batch and returns the loss before the update (a 0-d tensor on the
    device). The defaults are JAX's: the loss follows ``cfg.fused_loss``
    and the Adam tail is one kernel per leaf (``"auto"``);
    ``fused_tail="off"`` keeps the op chain. ``dropout_key`` (a threefry
    ``uint32[2]`` the caller derives per step, as JAX's callers do) turns
    on cfg's dropout rates for that step.

    ``ddp`` (a ``parallel.DistributedDataParallel``) averages the
    gradients between the backward and the update, its comm state (the
    EF residuals) carried in ``train_step.ddp_state["comm_state"]``, the
    step count as the stochastic-rounding seed, its comm metrics (host
    scalars) in ``train_step.ddp_state["metrics"]``. Without ``ddp`` the
    step is unchanged.

    ``plan`` (a ``parallel.ParallelismPlan``; the mesh built beforehand)
    trains through the plan's strategy with ``plan.build_optimizer(lr=
    1e-4)`` in place of ``FusedAdam``: ``ddp`` as ``ddp=plan.ddp()``;
    ``zero1`` hands the leaves' gradients to ``opt.step(grads, state,
    params)`` and writes the gathered parameters back into the leaves;
    ``fsdp`` differentiates the fp32 master shards through the loss over
    ``plan.fsdp().gather(master, meta)`` (the returned ``params`` are then
    the initial weights only). The carried state lives in
    ``train_step.plan_state``: ``"state"`` (the optimizer's), ``"comm_state"``
    (zero1's EF residuals), ``"meta"`` (fsdp's), ``"step"``; the step
    count seeds stochastic rounding."""
    cfg.validate()
    if seq > cfg.max_seq:
        raise ValueError(f"seq ({seq}) exceeds max_seq ({cfg.max_seq})")
    dev = resolve_device(device)
    params = init_gpt_params(cfg, seed=seed, device=dev)
    tok = _tokens(np.random.default_rng(seed + 1), cfg.vocab_size, batch,
                  seq, dev)
    tgt = torch.roll(tok, -1, dims=1)
    if plan is not None:
        if ddp is not None:
            raise ValueError("pass ddp= or plan=, not both")
        step, optimizer = _plan_step(
            plan, params,
            lambda p, key: gpt_loss(p, tok, tgt, cfg, dropout_key=key))
        return step, params, optimizer, tok, tgt
    step, optimizer = _step_over(
        params, fused_tail,
        lambda key: gpt_loss(params, tok, tgt, cfg, dropout_key=key), ddp)
    return step, params, optimizer, tok, tgt


def build_t5_train_step(cfg: T5Config, batch: int, seq_enc: int,
                        seq_dec: int, device: DeviceLike = None,
                        seed: int = 0) -> Tuple[Callable[[], torch.Tensor],
                                   Dict[str, Any], FusedAdam,
                                   Tuple[torch.Tensor, ...]]:
    """Returns ``(train_step, params, optimizer, (enc, dec, tgt))``: each
    call of ``train_step(dropout_key=None)`` runs one ``t5_loss`` fwd +
    bwd and the ``FusedAdam(lr=1e-4, fused_tail="auto")`` update on the
    fixed batch (encoder tokens (batch, seq_enc), decoder tokens (batch,
    seq_dec), targets the decoder tokens rolled by one) and returns the
    loss before the update; ``dropout_key`` as in
    :func:`build_train_step`."""
    cfg.validate()
    for what, seq, most in (("seq_enc", seq_enc, cfg.max_seq_enc),
                            ("seq_dec", seq_dec, cfg.max_seq_dec)):
        if seq > most:
            raise ValueError(f"{what} ({seq}) exceeds its max ({most})")
    dev = resolve_device(device)
    params = init_t5_params(cfg, seed=seed, device=dev)
    rng = np.random.default_rng(seed + 1)
    enc = _tokens(rng, cfg.vocab_size, batch, seq_enc, dev)
    dec = _tokens(rng, cfg.vocab_size, batch, seq_dec, dev)
    tgt = torch.roll(dec, -1, dims=1)
    step, optimizer = _step_over(
        params, "auto",
        lambda key: t5_loss(params, enc, dec, tgt, cfg, dropout_key=key))
    return step, params, optimizer, (enc, dec, tgt)


def _tokens(rng, vocab: int, batch: int, seq: int, dev) -> torch.Tensor:
    return torch.from_numpy(
        rng.integers(0, vocab, (batch, seq)).astype(np.int64)).to(dev)


def _step_over(params, fused_tail: str, loss_fn, ddp=None):
    """The step closure over ``loss_fn(dropout_key)`` and a
    ``FusedAdam(lr=1e-4)`` over every leaf of ``params`` (made trainable
    here); with ``ddp``, its gradient average between the backward and
    the update."""
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    optimizer = FusedAdam(leaves, lr=1e-4, fused_tail=fused_tail)
    state: Dict[str, Any] = {}
    if ddp is not None:
        state.update(comm_state=ddp.init_comm_state(leaves), metrics=None,
                     step=0)

    def train_step(dropout_key=None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(dropout_key)
        loss.backward()
        if ddp is not None:
            _average(ddp, leaves, state)
        optimizer.step()
        return loss.detach()

    train_step.ddp_state = state
    return train_step, optimizer


def _average(ddp, leaves, state: Dict[str, Any]) -> None:
    """``ddp.average_gradients`` over the leaves' gradients, written back
    as their ``.grad``; the comm state and metrics kept in ``state``."""
    from apex_tpu_torch.monitor.metrics import Metrics

    cfg = ddp.compression
    seed = (state["step"] if cfg is not None and cfg.stochastic_rounding
            else None)
    out = ddp.average_gradients(
        [p.grad for p in leaves], comm_state=state["comm_state"], seed=seed,
        metrics=Metrics())
    for p, g in zip(leaves, out[0]):
        p.grad = g
    if state["comm_state"] is not None:
        state["comm_state"] = out[1]
    state["metrics"] = out[-1]
    state["step"] += 1


def _plan_step(plan, params, loss_of):
    """The step closure of :func:`build_train_step`'s ``plan``:
    ``loss_of(params_tree, dropout_key)`` trained through the plan's data
    strategy with ``plan.build_optimizer(lr=1e-4)``."""
    from apex_tpu_torch.optimizers._common import (tree_leaves,
                                                   tree_unflatten)

    if plan.data == "ddp":
        return _step_over(params, plan.fused_update,
                          lambda key: loss_of(params, key), plan.ddp())
    opt = plan.build_optimizer(lr=1e-4)
    cfg = plan.compression
    stochastic = cfg is not None and cfg.stochastic_rounding
    state: Dict[str, Any] = {"step": 0, "state": opt.init(params),
                             "comm_state": None, "meta": None}
    if plan.data == "zero1":
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        state["comm_state"] = opt.init_comm_state(params)

        def train_step(dropout_key=None) -> torch.Tensor:
            loss = loss_of(params, dropout_key)
            grads = torch.autograd.grad(loss, leaves)
            out = opt.step(tree_unflatten(params, list(grads)),
                           state["state"], params,
                           comm_state=state["comm_state"],
                           seed=state["step"] if stochastic else None)
            state["state"] = out[1]
            if state["comm_state"] is not None:
                state["comm_state"] = out[2]
            with torch.no_grad():
                for p, new in zip(leaves, tree_leaves(out[0])):
                    p.copy_(new)
            state["step"] += 1
            return loss.detach()
    else:
        fsdp = opt.fsdp
        state["meta"] = fsdp.meta(params)

        def train_step(dropout_key=None) -> torch.Tensor:
            master = state["state"].master
            shards = [m.requires_grad_(True) for m in tree_leaves(master)]
            loss = loss_of(fsdp.gather(master, state["meta"]), dropout_key)
            grads = torch.autograd.grad(loss, shards)
            state["state"] = opt.step(tree_unflatten(master, list(grads)),
                                      state["state"])
            state["step"] += 1
            return loss.detach()

    train_step.plan_state = state
    return train_step, opt
