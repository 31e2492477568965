"""amp frontend: the opt-level presets, param casting, fp32 masters and
the guarded optimizer step (counterpart of ``apex_tpu/amp/frontend.py``).

Params are the port's nested dicts of tensors. Typical O2 step (GPT-2 on
the card; ``gpt_loss`` from ``transformer.testing``)::

    amp_state, policy = amp.initialize(params, "O2")    # fp32 masters
    model = amp.model_params(amp_state)                  # bf16 copy, LN fp32
    leaves = amp.trainable_leaves(model)
    opt = FusedAdam(tree_leaves(amp_state.master_params), lr=1e-4)

    def step():
        amp.model_params(amp_state, out=model)           # copy_ in place
        loss = gpt_loss(model, tok, tgt, cfg)
        grads = torch.autograd.grad(amp.scale_loss(loss, amp_state), leaves)
        state, _, skipped = amp.apply_grads_with_optimizer(
            amp_state, grads, opt)                       # masters in place
        return loss

On an overflow step the masters, every optimizer state tensor and the
step count stay as they were and the scale backs off, all decided on the
device: nothing is read back to the host.
"""

from __future__ import annotations

import re
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState
from apex_tpu_torch.config import PrecisionConfig
from apex_tpu_torch.optimizers._common import (tree_leaves, tree_map,
                                               tree_unflatten)

_HALF = torch.float16
_BF16 = torch.bfloat16


def _preset(opt_level: str, half_dtype) -> PrecisionConfig:
    if opt_level == "O0":  # fp32 training
        return PrecisionConfig(opt_level="O0", cast_model_type=None,
                               compute_dtype=None, keep_batchnorm_fp32=None,
                               master_weights=False, loss_scale=1.0)
    if opt_level == "O1":  # per-op casting (autocast)
        return PrecisionConfig(opt_level="O1", cast_model_type=None,
                               compute_dtype=half_dtype,
                               keep_batchnorm_fp32=None,
                               master_weights=None, loss_scale="dynamic")
    if opt_level == "O2":  # half model + fp32 masters + fp32 norms
        return PrecisionConfig(opt_level="O2", cast_model_type=half_dtype,
                               compute_dtype=None, keep_batchnorm_fp32=True,
                               master_weights=True, loss_scale="dynamic")
    if opt_level == "O3":  # pure half
        return PrecisionConfig(opt_level="O3", cast_model_type=half_dtype,
                               compute_dtype=None,
                               keep_batchnorm_fp32=False,
                               master_weights=False, loss_scale=1.0)
    if opt_level == "FP8":  # e4m3 / e5m2 products with delayed scaling
        return PrecisionConfig(opt_level="FP8", cast_model_type=None,
                               compute_dtype=torch.float8_e4m3fn,
                               keep_batchnorm_fp32=True, master_weights=True,
                               loss_scale=1.0)
    raise ValueError(
        f"Unexpected optimization level {opt_level!r} "
        "(options are 'O0', 'O1', 'O2', 'O3', 'FP8')")


def policy_compute_dtype(policy: PrecisionConfig):
    """The low-precision dtype a policy declares: the O2/O3 model cast,
    else the O1 compute dtype, else None (O0)."""
    dt = (getattr(policy, "cast_model_type", None)
          or getattr(policy, "compute_dtype", None))
    return dt


def get_policy(opt_level: str = "O0", half_dtype=_BF16,
               **overrides) -> PrecisionConfig:
    """An opt level + overrides -> :class:`PrecisionConfig`. ``half_dtype``
    defaults to bf16, as JAX; ``torch.float16`` for the reference's fp16."""
    cfg = _preset(opt_level, half_dtype)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


# ---------------------------------------------------------------------------
# param casting

_NORM_COMPONENT = re.compile(
    r"((fused|mixedfused|sync)?(batch|group|layer|rms|instance)?norm[a-z0-9]{0,3}"
    r"|(bn|gn|ln)[a-z0-9]{0,3})$")


def default_norm_predicate(path: str) -> bool:
    """Whether a param is a normalization param, from its ``a/b/c`` path
    (JAX's form: a user predicate sees the same path on both sides).
    Matches components such as ``BatchNorm_0``, ``layer_norm``, ``ln_f``,
    ``bn1`` and GPT's ``ln1_w``, ``ln2_b``, ``head/ln_w``."""
    return any(_NORM_COMPONENT.fullmatch(c.lower().replace("_", ""))
               for c in path.split("/"))


def _map_with_path(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_with_path(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _is_float(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point()


def cast_params(params: Any, policy: PrecisionConfig,
                is_norm_param: Callable[[str], bool] = default_norm_predicate
                ) -> Any:
    """Float leaves to ``cast_model_type``, normalization params to fp32
    when ``keep_batchnorm_fp32`` (new tensors; the tree when there is no
    model cast)."""
    if policy.cast_model_type is None:
        return params
    target = policy.cast_model_type

    def leaf(path, x):
        if not _is_float(x):
            return x
        if policy.keep_batchnorm_fp32 and is_norm_param(path):
            return x.to(torch.float32)
        return x.to(target)

    return _map_with_path(leaf, params)


def cast_inputs(args: Any, policy: PrecisionConfig) -> Any:
    """Float inputs to the model cast type (the patched forward's cast)."""
    if policy.cast_model_type is None:
        return args
    t = policy.cast_model_type
    return tree_map(lambda x: x.to(t) if _is_float(x) else x, args)


# ---------------------------------------------------------------------------
# initialize + the master-weight step


class AmpState(NamedTuple):
    """What ``amp.initialize`` hangs off the model and the optimizer in the
    reference, as one explicit value: the masters (fp32 copies when the
    policy keeps them, else the model params), the scaler state, the
    policy and the keep-fp32 predicate."""

    master_params: Any
    scaler: LossScalerState
    policy: PrecisionConfig
    is_norm_param: Callable[[str], bool]


def make_scaler(policy: PrecisionConfig) -> LossScaler:
    return LossScaler(policy.loss_scale)


def _device_of(tree, device):
    if device is not None:
        return device
    leaves = [x for x in tree_leaves(tree) if torch.is_tensor(x)]
    return leaves[0].device if leaves else None


def initialize(params: Any, opt_level: str = "O0", half_dtype=_BF16,
               is_norm_param: Callable[[str], bool] = default_norm_predicate,
               device=None, **overrides) -> Tuple[AmpState, PrecisionConfig]:
    """Resolve the policy, make fp32 masters (new tensors, detached) if it
    keeps them, and the scaler's state on the params' device (or
    ``device``; default ``cuda`` for a tree without tensors). Returns
    ``(amp_state, policy)``."""
    policy = get_policy(opt_level, half_dtype, **overrides)
    if policy.master_weights:
        masters = tree_map(
            lambda x: (x.detach().to(torch.float32, copy=True)
                       if _is_float(x) else x), params)
    else:
        masters = params
    scaler = make_scaler(policy)
    state = scaler.init_state(_device_of(params, device))
    return AmpState(masters, state, policy, is_norm_param), policy


def model_params(state: AmpState, out: Any = None) -> Any:
    """The model-dtype view of the masters (JAX's cast-on-forward). With
    ``out`` (a tree from an earlier call) the cast is written into its
    leaves with ``copy_``, so autograd leaves and a remat tape keep their
    identity across steps; it is returned."""
    view = cast_params(state.master_params, state.policy,
                       state.is_norm_param)
    if out is None:
        return view
    with torch.no_grad():
        for dst, src in zip(tree_leaves(out), tree_leaves(view)):
            if dst is not src:
                dst.copy_(src)
    return out


def trainable_leaves(tree: Any):
    """The float leaves of ``tree``, each set to require grad (the
    tensors to differentiate the model's loss with)."""
    leaves = [x for x in tree_leaves(tree) if _is_float(x)]
    for x in leaves:
        x.requires_grad_(True)
    return leaves


def scale_loss(loss: torch.Tensor, state: AmpState) -> torch.Tensor:
    """``loss`` in fp32 times the current scale."""
    return make_scaler(state.policy).scale_loss(loss, state.scaler)


def _unscale_and_check(state: AmpState, grads: Any, mp_group):
    scaler = make_scaler(state.policy)
    out_dtype = torch.float32 if state.policy.master_weights else None
    grads, found_inf = scaler.unscale(grads, state.scaler,
                                      out_dtype=out_dtype)
    if mp_group is not None:
        found_inf = LossScaler.all_reduce_found_inf(found_inf, mp_group)
    new_scaler_state, skipped = scaler.update_scale(state.scaler, found_inf)
    return grads, new_scaler_state, skipped


def _guard_tree(skipped, new, old):
    """``old`` where ``skipped``, else ``new``, leaf by leaf (a device
    select: no host read)."""
    return tree_map(lambda n, o: torch.where(skipped, o, n)
                    if torch.is_tensor(n) else n, new, old)


def _as_tree(grads: Any, like: Any) -> Any:
    """A flat list of gradients (``torch.autograd.grad``'s output over
    ``tree_leaves(like)``) as a tree shaped like ``like``."""
    if isinstance(like, (list, tuple)) or not isinstance(grads,
                                                          (list, tuple)):
        return grads
    return tree_unflatten(like, grads)


def apply_grads(state: AmpState, grads: Any,
                update_fn: Callable[[Any, Any], Any], mp_group=None
                ) -> Tuple[AmpState, torch.Tensor]:
    """Unscale, check for overflow, ``update_fn(grads, masters) ->
    new_masters`` guarded by the skip, update the scale. Returns
    ``(new_state, skipped)`` (new master tensors, as JAX). ``mp_group``:
    a ``torch.distributed`` group, or the mesh's axis names (JAX's
    ``mp_axes``), to MAX-reduce the flag over."""
    grads = _as_tree(grads, state.master_params)
    grads, new_scaler_state, skipped = _unscale_and_check(state, grads,
                                                          mp_group)
    new_masters = update_fn(grads, state.master_params)
    guarded = _guard_tree(skipped, new_masters, state.master_params)
    return AmpState(guarded, new_scaler_state, state.policy,
                    state.is_norm_param), skipped


def apply_grads_with_optimizer(state: AmpState, grads: Any, optimizer,
                               mp_group=None):
    """:func:`apply_grads` for a port optimizer over the leaves of
    ``state.master_params``: unscale into the masters' ``.grad``, check for
    overflow, update the scale, and run ``optimizer.step(found_inf=...)``,
    which updates the masters and its state in place and keeps them, and
    its count, where the flag is set. Returns ``(amp_state, optimizer,
    skipped)`` (JAX returns the new optimizer state; here the optimizer
    holds it)."""
    grads = _as_tree(grads, state.master_params)
    grads, new_scaler_state, skipped = _unscale_and_check(state, grads,
                                                          mp_group)
    for p, g in zip(tree_leaves(state.master_params), tree_leaves(grads)):
        p.grad = g
    optimizer.step(found_inf=skipped.to(torch.float32))
    return (AmpState(state.master_params, new_scaler_state, state.policy,
                     state.is_norm_param), optimizer, skipped)


# ---------------------------------------------------------------------------
# checkpointing


def state_dict(state: AmpState) -> dict:
    return {"loss_scaler0": make_scaler(state.policy).state_dict(
        state.scaler)}


def load_state_dict(state: AmpState, d: dict) -> AmpState:
    scaler = make_scaler(state.policy)
    return state._replace(scaler=scaler.load_state_dict(
        d["loss_scaler0"], device=state.scaler.loss_scale.device))
