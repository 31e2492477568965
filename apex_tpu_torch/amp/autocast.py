"""O1-style per-op mixed precision for eager PyTorch (counterpart of
``apex_tpu/amp/autocast.py``).

JAX traces the function and re-evaluates its jaxpr under per-primitive
rules. Eager PyTorch has no trace, so :func:`autocast` runs the function
under a ``torch.overrides.TorchFunctionMode`` that applies the tables of
:mod:`apex_tpu_torch.amp.lists` to each torch function call:

* products (``matmul``, ``linear``, ``conv*`` ...) on the compute dtype,
  their result in it; an added bias at the wider dtype;
* the fp32 list on fp32;
* anything else with float tensor inputs of several dtypes on the widest.

Control flow is Python (loops, ``if``, ``torch.where``), so JAX's
scan / cond / while bodies need no special case. The port's custom-
gradient regions (``_kernel_util.OpaqueFunction``) are opaque: their float
inputs go back to the dtype each value would have had without autocast
and their bodies run with the mode suspended. That dtype is tracked per
tensor: the mode records, beside each output whose dtype it changed, the
dtype torch's promotion gives over the inputs' own un-autocast dtypes
(an explicit conversion keeps the dtype it asks for). Remat: a layer
under ``torch.utils.checkpoint`` recomputes in backward, outside the
caller's ``with``; ``tensor_parallel.random.checkpoint_saving`` enters the
same mode around the recompute (:func:`active_mode`), so the recomputed
dtypes are the forward's, as JAX inlines remat under the same casts.
"""

from __future__ import annotations

import contextvars
import functools
from typing import Any, Callable, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.weak import WeakIdKeyDictionary

from apex_tpu_torch.amp.lists import (CONDITIONAL, CONVERSIONS, FP16_FUNCS,
                                      FP32_FUNCS)
from apex_tpu_torch.ops import _kernel_util as ku

_ACTIVE_COMPUTE_DTYPE: contextvars.ContextVar = contextvars.ContextVar(
    "apex_tpu_torch_autocast_compute_dtype", default=None)
_MODES: list = []


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    if isinstance(x, dict):
        return [y for v in x.values() for y in _flat(v)]
    return [x]


def _map(fn, x):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    return fn(x)


def _cast(x, dtype):
    if _is_float(x) and x.dtype != dtype:
        return x.to(dtype)
    return x


def _widest(dtypes) -> Optional[torch.dtype]:
    dt = None
    for d in dtypes:
        dt = d if dt is None else torch.promote_types(dt, d)
    return dt


# in-place operators: never rewritten (a cast would write into a copy)
_IN_PLACE = frozenset({
    "__setitem__", "__iadd__", "__isub__", "__imul__", "__itruediv__",
    "__ifloordiv__", "__imod__", "__ipow__", "__imatmul__", "__iand__",
    "__ior__", "__ixor__", "__ilshift__", "__irshift__"})


def _rule(name: str, args, kwargs) -> str:
    """"half", "float", "keep" (untouched) or "promote"."""
    if name in CONVERSIONS or kwargs.get("dtype") is not None or (
            name in _IN_PLACE) or (
            name.endswith("_") and not name.startswith("__")):
        return "keep"
    if name in FP16_FUNCS:
        return "half"
    if name in FP32_FUNCS:
        return "float"
    if name in CONDITIONAL:
        if name == "gelu":
            approx = kwargs.get("approximate",
                                args[1] if len(args) > 1 else "none")
            return "float" if approx == "none" else "promote"
        exp = args[1] if len(args) > 1 else kwargs.get("exponent")
        if name == "__rpow__" or isinstance(exp, torch.Tensor) or (
                isinstance(exp, float)):
            return "float"
        return "promote"
    return "promote"


def _bias_shape(name: str, bias, out):
    """A conv bias broadcast over the output's channel dim (dim 1)."""
    if name.startswith("conv"):
        return bias.reshape((1, -1) + (1,) * (out.dim() - 2))
    return bias


class _AutocastMode(TorchFunctionMode):
    """The per-call cast rules (module docstring)."""

    def __init__(self, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        # each tensor whose dtype autocast changed -> its un-autocast dtype
        self.shadow = WeakIdKeyDictionary()
        self._tokens: list = []
        self._hooks: list = []

    def __enter__(self):
        _MODES.append(self)
        self._tokens.append(_ACTIVE_COMPUTE_DTYPE.set(self.compute_dtype))
        self._hooks.append(ku._OPAQUE_HOOK[0])
        ku._OPAQUE_HOOK[0] = self._opaque
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ku._OPAQUE_HOOK[0] = self._hooks.pop()
            _ACTIVE_COMPUTE_DTYPE.reset(self._tokens.pop())
            _MODES.pop()

    def untraced_dtype(self, t: torch.Tensor) -> torch.dtype:
        """The dtype ``t`` would have had without autocast."""
        return self.shadow.get(t, t.dtype)

    def _opaque(self, apply, args, kwargs):
        args = _map(lambda x: _cast(x, self.untraced_dtype(x))
                    if _is_float(x) else x, args)
        kwargs = _map(lambda x: _cast(x, self.untraced_dtype(x))
                      if _is_float(x) else x, kwargs)
        with torch._C.DisableTorchFunction():
            return apply(*args, **kwargs)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        rule = _rule(name, args, kwargs)
        ins = [x for x in _flat((args, kwargs)) if _is_float(x)]
        if rule == "keep" or not ins:
            return func(*args, **kwargs)
        if rule == "half":
            out = self._product(func, name, args, kwargs)
        else:
            if rule == "float":
                target = torch.float32
            else:
                target = _widest(t.dtype for t in ins)
                if len({t.dtype for t in ins}) < 2:
                    target = None
            if target is not None:
                args = _map(lambda x: _cast(x, target), args)
                kwargs = _map(lambda x: _cast(x, target), kwargs)
            out = func(*args, **kwargs)
        self._record(ins, out)
        return out

    def _product(self, func, name, args, kwargs):
        """A whitelisted product on the compute dtype; an added term
        (``linear``/``conv`` bias, ``addmm``/``baddbmm`` input) is added
        afterwards at the wider dtype, as JAX's dot then add."""
        half = lambda x: _cast(x, self.compute_dtype)
        if name in ("linear",) or name.startswith("conv"):
            args, kwargs = list(args), dict(kwargs)
            bias = kwargs.pop("bias", None)
            if len(args) > 2:
                bias, args[2] = args[2], None
            out = func(*_map(half, args), **_map(half, kwargs))
            if bias is None:
                return out
            bias = _bias_shape(name, bias, out)
            wide = torch.promote_types(out.dtype, bias.dtype)
            return out.to(wide) + bias.to(wide)
        if name in ("addmm", "baddbmm"):
            inp, a, b = args[:3]
            beta, alpha = kwargs.get("beta", 1), kwargs.get("alpha", 1)
            mm = torch.mm if name == "addmm" else torch.bmm
            prod = mm(half(a), half(b))
            if alpha != 1:
                prod = prod * alpha
            wide = torch.promote_types(prod.dtype, inp.dtype)
            term = inp if beta == 1 else inp * beta
            return prod.to(wide) + term.to(wide)
        return func(*_map(half, args), **_map(half, kwargs))

    def _record(self, ins, out) -> None:
        shadow = _widest(self.untraced_dtype(t) for t in ins)
        for o in _flat(out):
            if _is_float(o) and o.dtype != shadow:
                self.shadow[o] = shadow


def active_mode() -> Optional[_AutocastMode]:
    """The innermost active autocast mode, or None (for the remat
    recompute to re-enter)."""
    return _MODES[-1] if _MODES else None


def autocast(fn: Callable, compute_dtype=torch.bfloat16,
             enabled: bool = True) -> Callable:
    """Wrap ``fn`` so its float ops run under the O1 per-op cast policy
    (module docstring). ``enabled=False`` returns ``fn`` itself. Outputs
    keep the dtypes autocast gave them, as JAX's."""
    if not enabled:
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _AutocastMode(compute_dtype):
            return fn(*args, **kwargs)

    return wrapped


# ---------------------------------------------------------------------------
# user registration decorators (ref apex/amp/amp.py:30-64)


def _region(fn, dtype_of):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        dt = dtype_of()
        if dt is None:  # no autocast active: the raw function
            return fn(*args, **kwargs)
        args, kwargs = _map(lambda x: _cast(x, dt), (args, kwargs))
        return fn(*args, **kwargs)

    return wrapped


def half_function(fn: Callable) -> Callable:
    """Cast ``fn``'s float inputs to the active compute dtype."""
    return _region(fn, _ACTIVE_COMPUTE_DTYPE.get)


def float_function(fn: Callable) -> Callable:
    """Cast ``fn``'s float inputs to fp32 while autocast is active."""
    return _region(fn, lambda: torch.float32
                   if _ACTIVE_COMPUTE_DTYPE.get() is not None else None)


def promote_function(fn: Callable) -> Callable:
    """Promote ``fn``'s float inputs to their widest dtype while autocast
    is active."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _ACTIVE_COMPUTE_DTYPE.get() is None:
            return fn(*args, **kwargs)
        wide = _widest(x.dtype for x in _flat((args, kwargs))
                       if _is_float(x))
        if wide is not None:
            args, kwargs = _map(lambda x: _cast(x, wide), (args, kwargs))
        return fn(*args, **kwargs)

    return wrapped
