"""Parameter trees from numpy: the JAX package's param pytree (and its LoRA
adapter weights, :func:`adapter_weights_from_numpy`), taken out as
numpy arrays (``jax.tree.map(np.asarray, params)``), becomes the port's
dict of torch tensors with the same keys, shapes and layout (stacked
layers, per-head interleaved QKV), so weights carry across one to one.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from apex_tpu_torch._device import DeviceLike, resolve_device


def tensor_from_numpy(a, device: torch.device,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One array -> tensor on ``device``. A bfloat16 array (numpy dtype
    named ``bfloat16``, which ``torch.from_numpy`` refuses) is moved as its
    raw 16-bit patterns and viewed back as ``torch.bfloat16``: exact."""
    a = np.asarray(a)
    if not a.flags.writeable:  # e.g. a JAX array's host view
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (default ``cuda``; raises without one unless ``device="cpu"``).
    ``dtype`` casts every floating leaf when given."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev, dtype)

    return conv(tree)


def named_leaves(tree: Any, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict in sorted-key order (the
    JAX tree order), paths joined by ``.``: ``("layers.qkv_kernel", t)``."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


def adam_state_from_numpy(jax_state_as_numpy: Any, params: Any,
                          optimizer) -> None:
    """Carry a JAX ``FusedAdamState`` (``count``, ``mu``, ``nu``, taken out
    as numpy: ``jax.tree.map(np.asarray, state)``) into ``optimizer``, a
    port :class:`~apex_tpu_torch.optimizers.FusedAdam` over the leaves of
    ``params`` (the same nested-dict tree as ``mu``/``nu``). Each param's
    ``exp_avg``/``exp_avg_sq`` become fp32 copies of its moments on the
    param's device, and every group's step count becomes ``count``, so a
    run can continue from the JAX state."""
    state = (jax_state_as_numpy if isinstance(jax_state_as_numpy, dict)
             else jax_state_as_numpy._asdict())
    mu, nu = dict(named_leaves(state["mu"])), dict(named_leaves(state["nu"]))
    leaves = dict(named_leaves(params))
    if set(mu) != set(leaves) or set(nu) != set(leaves):
        raise ValueError(f"optimizer state leaves {sorted(mu)} do not match "
                         f"the params' {sorted(leaves)}")
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for name, p in leaves.items():
        if id(p) not in owned:
            raise ValueError(f"param {name} is not in the optimizer")
        if np.shape(mu[name]) != tuple(p.shape):
            raise ValueError(f"{name}: moment shape {np.shape(mu[name])} "
                             f"does not match param shape {tuple(p.shape)}")
        optimizer.state[p] = {
            "exp_avg": tensor_from_numpy(mu[name], p.device, torch.float32),
            "exp_avg_sq": tensor_from_numpy(nu[name], p.device,
                                            torch.float32),
        }
    for g in optimizer.param_groups:
        g["step"] = int(np.asarray(state["count"]))


def norm_state_from_numpy(params: Any, device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None) -> dict:
    """A flax norm module's params (JAX's ``FusedLayerNorm`` /
    ``FusedRMSNorm`` and the ``Mixed*`` variants: ``{"scale", "bias"}`` as
    numpy, optionally under a ``"params"`` key) -> the port module's state
    dict (``weight``, and ``bias`` where JAX has one), for
    ``module.load_state_dict``. ``dtype`` casts the leaves when given."""
    if "params" in params:
        params = params["params"]
    names = {"scale": "weight", "bias": "bias"}
    extra = set(params) - set(names)
    if extra:
        raise ValueError(f"not a norm module's params: {sorted(extra)}")
    dev = resolve_device(device)
    return {names[k]: tensor_from_numpy(v, dev, dtype)
            for k, v in params.items()}


def adapter_weights_from_numpy(weights: Any, device: DeviceLike = None,
                               dtype: Optional[torch.dtype] = None) -> dict:
    """JAX's ``serve.adapters.make_adapter_weights`` output, taken out as
    numpy (``jax.tree.map(np.asarray, w)``): ``{f"{t}_a", f"{t}_b"}`` for
    each adapted projection t -> the same dict of tensors on ``device``,
    for ``InferenceEngine.load_adapter`` / ``write_adapter``. Raises on a
    missing or unknown key."""
    from apex_tpu_torch.serve.adapters import ADAPTER_TARGETS

    want = {f"{t}_{side}" for t in ADAPTER_TARGETS for side in ("a", "b")}
    if set(weights) != want:
        raise ValueError(f"adapter weights have keys {sorted(weights)}, "
                         f"want {sorted(want)}")
    return params_from_numpy(dict(weights), device, dtype)


def _flat(tree: Any, prefix: str = "") -> dict:
    """A nested dict's leaves under ``.``-joined names."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _owner_layout(module: torch.nn.Module, name: str, to_port: bool):
    """The function that moves the array of parameter ``name`` between
    flax's layout and its port module's (the owner's ``from_flax`` /
    ``to_flax``: conv kernels transposed, transposed-conv kernels
    flipped); identity for a module that has none."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    fn = getattr(owner, "from_flax" if to_port else "to_flax", None)
    return (lambda a: fn(leaf, a)) if fn else (lambda a: a)


def module_from_numpy(params: Any, module: torch.nn.Module,
                      batch_stats: Any = None) -> None:
    """A flax module's variables (as numpy) copied into the port module
    whose parameters carry the same names and shapes: JAX's ``MLP``,
    ``FusedDense``, ``FusedDenseGeluDense`` (flat ``{name: array}``), the
    attention modules, and nested trees (``models``: ``BottleneckBlock_0``
    / ``Conv_1`` / ``kernel`` -> ``BottleneckBlock_0.Conv_1.kernel``),
    optionally under a ``"params"`` key with a ``"batch_stats"`` one
    beside it (or ``batch_stats`` given), whose leaves go into the
    buffers of the same names. Each array goes through its owner's
    ``from_flax`` (conv kernels HWIO -> OIHW, transposed-conv kernels
    flipped) and into the parameter's own type and device. Raises on a
    missing or extra name or a shape that differs."""
    if set(params) <= {"params", "batch_stats"}:   # flax's variables
        batch_stats = params.get("batch_stats", batch_stats)
        params = params.get("params", {})
    for tree, own in ((params, dict(module.named_parameters())),
                      (batch_stats, dict(module.named_buffers()))):
        if tree is None:
            continue
        flat = _flat(tree)
        if set(flat) != set(own):
            raise ValueError(f"variables {sorted(flat)} do not match the "
                             f"module's {sorted(own)}")
        with torch.no_grad():
            for name, p in own.items():
                a = _owner_layout(module, name, True)(np.asarray(flat[name]))
                if np.shape(a) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {np.shape(a)} does not "
                                     f"match {tuple(p.shape)}")
                p.copy_(tensor_from_numpy(a, p.device, p.dtype))


def param_tree(module: torch.nn.Module) -> dict:
    """The module's parameters as a nested dict under flax's paths
    (``BottleneckBlock_0`` / ``Conv_1`` / ``kernel``), the tensors
    themselves: the tree ``amp`` and the optimizers take (amp's norm
    predicate reads these paths as it reads JAX's)."""
    out: dict = {}
    for name, p in module.named_parameters():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = p
    return out


def module_to_flax(tensors: Any, module: torch.nn.Module) -> Any:
    """``{name: tensor}`` of a port module's parameters (their values or
    their gradients) as flax's nested tree of numpy arrays in flax's
    layouts: the inverse of :func:`module_from_numpy`'s moves, for
    comparing with JAX."""
    out: dict = {}
    for name, t in tensors.items():
        a = t.detach().float().cpu().numpy()
        a = _owner_layout(module, name, False)(a)
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return out


# the port optimizers' per-param state names for the JAX state fields
_OPT_STATE_FIELDS = {"momentum_buffer": "momentum_buffer", "sum": "sum",
                     "mu": "exp_avg", "nu": "exp_avg_sq"}


def optimizer_state_from_numpy(jax_state_as_numpy: Any, params: Any,
                               optimizer) -> None:
    """Carry a JAX ``FusedSGDState`` / ``FusedAdagradState`` /
    ``FusedNovoGradState`` / ``FusedLAMBState`` (as numpy:
    ``jax.tree.map(np.asarray, state)``) into the port optimizer of the
    same name over the leaves of ``params``: each per-leaf field becomes
    the param's fp32 state entry (``momentum_buffer``, ``sum``,
    ``exp_avg`` for ``mu``, ``exp_avg_sq`` for ``nu``) and ``count`` every
    group's device step count."""
    state = (jax_state_as_numpy if isinstance(jax_state_as_numpy, dict)
             else jax_state_as_numpy._asdict())
    leaves = dict(named_leaves(params))
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    fields = {f: dict(named_leaves(state[f])) for f in state
              if f in _OPT_STATE_FIELDS}
    for name, p in leaves.items():
        if id(p) not in owned:
            raise ValueError(f"param {name} is not in the optimizer")
        entry = {}
        for f, tree in fields.items():
            if name not in tree:
                raise ValueError(f"state field {f} has no leaf {name}")
            entry[_OPT_STATE_FIELDS[f]] = tensor_from_numpy(
                tree[name], p.device, torch.float32)
        optimizer.state[p] = entry
    for g in optimizer.param_groups:
        dev = g["params"][0].device
        g["step"] = torch.full((), int(np.asarray(state["count"])),
                               dtype=torch.int32, device=dev)


def scaler_state_from_numpy(jax_scaler_as_numpy: Any,
                            device: DeviceLike = None):
    """A JAX ``LossScalerState`` (as numpy) -> the port's, on ``device``."""
    from apex_tpu_torch.amp.scaler import LossScalerState

    dev = resolve_device(device)
    s = jax_scaler_as_numpy
    return LossScalerState(
        torch.full((), float(np.asarray(s.loss_scale)), dtype=torch.float32,
                   device=dev),
        torch.full((), int(np.asarray(s.unskipped)), dtype=torch.int32,
                   device=dev),
        torch.full((), int(np.asarray(s.hysteresis_left)),
                   dtype=torch.int32, device=dev))


def _torch_dtype(dt):
    if dt is None:
        return None
    return getattr(torch, np.dtype(dt).name)


def amp_state_from_numpy(jax_amp_state_as_numpy: Any,
                         device: DeviceLike = None, is_norm_param=None):
    """A JAX ``AmpState`` (``jax.tree.map(np.asarray, state)``: masters and
    scaler as numpy, the policy as it was) -> the port's ``AmpState`` on
    ``device``: the masters in their dtypes, the scaler state, the policy
    with torch dtypes and ``is_norm_param`` (default: the port's
    ``default_norm_predicate``, JAX's rule)."""
    from apex_tpu_torch.amp.frontend import AmpState, default_norm_predicate
    from apex_tpu_torch.config import PrecisionConfig

    s = jax_amp_state_as_numpy
    pol = s.policy
    policy = PrecisionConfig(
        opt_level=pol.opt_level,
        cast_model_type=_torch_dtype(pol.cast_model_type),
        compute_dtype=_torch_dtype(pol.compute_dtype),
        keep_batchnorm_fp32=pol.keep_batchnorm_fp32,
        master_weights=pol.master_weights, loss_scale=pol.loss_scale)
    return AmpState(params_from_numpy(s.master_params, device),
                    scaler_state_from_numpy(s.scaler, device), policy,
                    is_norm_param or default_norm_predicate)


def fp8_state_from_numpy(jax_fp8_state_as_numpy: Any,
                         device: DeviceLike = None):
    """A JAX fp8 state (a nested dict of ``Fp8DotState``, as numpy) -> the
    port's (``amp.fp8.Fp8DotState`` of fp32 tensors) on ``device``."""
    from apex_tpu_torch.amp.fp8 import Fp8DotState, Fp8TensorState

    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return Fp8DotState(*(Fp8TensorState(*(
            tensor_from_numpy(a, dev, torch.float32) for a in half))
            for half in (node.x, node.w, node.g)))

    return conv(jax_fp8_state_as_numpy)
