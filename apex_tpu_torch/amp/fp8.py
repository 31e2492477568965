"""fp8 policy tier — e4m3 forward / e5m2 gradient products with delayed
scaling (counterpart of ``apex_tpu/amp/fp8.py``).

The operands of a product are cast to ``float8_e4m3fn`` in the forward
and the incoming gradient to ``float8_e5m2`` in the backward, each with a
per-tensor scale chosen by delayed scaling: the scale a cast uses at step
k comes from the amax history of the steps before it, so the cast is a
function of carried state (0-d / 1-d fp32 tensors on the device).

The gradient half of a product's state: JAX's custom-VJP backward cannot
emit a primal output, so JAX returns it as the cotangent of the state
argument and :func:`merge_state_grads` stitches it in. The port's
backward records it instead: :func:`fp8_dot` returns a state whose ``g``
half is new tensors that the backward fills in, so after ``backward()``
``merge_state_grads(fwd_states)`` gives the same state as JAX's merge.

The product itself is no TPU kernel (JAX computes it with
``lax.dot_general`` outside any Pallas kernel). :func:`fp8_matmul` runs it
on one of two routes, chosen by shape before the call: on the card
``torch._scaled_mm`` (Hopper's fp8 tensor cores, fp32 out, no fast
accumulation) where every dimension is a multiple of 16 and not both
operands are e5m2, else the fp32 product of the exactly upcast operands
(every fp8 product is exact in fp32; the sums differ in order only).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.ops import _kernel_util as ku

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2


def fp8_max(dtype) -> float:
    """Largest finite value of an fp8 dtype (448 for e4m3fn, 57344 for
    e5m2): the clip bound of :func:`cast_fp8`."""
    return float(torch.finfo(dtype).max)


@dataclasses.dataclass(frozen=True)
class Fp8Recipe:
    """Static delayed-scaling knobs: ``history_len`` (amax window),
    ``margin`` (scale = fp8_max / (max(history) · 2^margin)) and the
    e4m3 / e5m2 split."""

    history_len: int = 16
    margin: float = 0.0
    fwd_dtype: Any = E4M3
    grad_dtype: Any = E5M2

    def __post_init__(self):
        if self.history_len < 1:
            raise ValueError("history_len must be >= 1")
        if self.margin < 0:
            raise ValueError("margin must be >= 0")


class Fp8TensorState(NamedTuple):
    """A cast site's state: the scale the next cast uses, the amax history
    it came from, and the last cast's saturated fraction."""

    scale: torch.Tensor          # 0-d fp32
    amax_history: torch.Tensor   # (history_len,) fp32
    overflow_rate: torch.Tensor  # 0-d fp32


def init_tensor_state(recipe: Fp8Recipe = Fp8Recipe(),
                      device: DeviceLike = None) -> Fp8TensorState:
    dev = resolve_device(device)
    return Fp8TensorState(
        torch.ones((), dtype=torch.float32, device=dev),
        torch.zeros((recipe.history_len,), dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.float32, device=dev))


class Fp8DotState(NamedTuple):
    """The three cast sites of one product: x and w (e4m3), g (e5m2)."""

    x: Fp8TensorState
    w: Fp8TensorState
    g: Fp8TensorState


def init_dot_state(recipe: Fp8Recipe = Fp8Recipe(),
                   device: DeviceLike = None) -> Fp8DotState:
    return Fp8DotState(*(init_tensor_state(recipe, device)
                         for _ in range(3)))


def init_fp8_state(names, recipe: Fp8Recipe = Fp8Recipe(),
                   device: DeviceLike = None) -> Dict[str, Fp8DotState]:
    """One :class:`Fp8DotState` per named product site."""
    return {str(n): init_dot_state(recipe, device) for n in names}


# ---------------------------------------------------------------------------
# cast + delayed-scale update


def cast_fp8(x: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Scale (in fp32), saturate at the fp8 max and round to ``dtype``
    (nearest even, JAX's rounding). The scale is state: not
    differentiated."""
    m = fp8_max(dtype)
    return torch.clamp(x.float() * scale.detach(), -m, m).to(dtype)


def _observe(x, scale, dtype):
    """(amax, overflow_rate) of casting ``x`` at ``scale``."""
    ax = torch.abs(x.detach().float())
    amax = torch.max(ax)
    over = torch.mean((ax * scale.detach() > fp8_max(dtype)).float())
    return amax, over


def update_tensor_state(state: Fp8TensorState, amax, overflow_rate, dtype,
                        recipe: Fp8Recipe = Fp8Recipe()) -> Fp8TensorState:
    """Roll ``amax`` into the history and derive the next scale from its
    maximum; an all-zero (or non-finite) history keeps the scale."""
    hist = torch.cat([state.amax_history[1:],
                      amax.reshape(1).float()])
    hmax = torch.max(hist)
    # a tensor numerator: JAX divides (torch would multiply a Python
    # number by the reciprocal)
    num = torch.full_like(hmax, fp8_max(dtype))
    new_scale = torch.where((hmax > 0) & torch.isfinite(hmax),
                            num / (hmax * 2.0 ** recipe.margin),
                            state.scale)
    return Fp8TensorState(new_scale.float(), hist,
                          torch.as_tensor(overflow_rate).float())


# ---------------------------------------------------------------------------
# the product routes


def fp8_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """``"scaled_mm"`` (the fp8 tensor cores) or ``"upcast"`` for the
    product of fp8 (M, K) ``a`` and (K, N) ``b``, from the shapes and
    types alone."""
    (m, k), n = a.shape, b.shape[1]
    if (a.is_cuda and m % 16 == 0 and k % 16 == 0 and n % 16 == 0
            and not (a.dtype == E5M2 and b.dtype == E5M2)):
        return "scaled_mm"
    return "upcast"


def fp8_matmul(a: torch.Tensor, b: torch.Tensor,
               route: Optional[str] = None) -> torch.Tensor:
    """fp32 (M, N) = a (M, K) @ b (K, N) of fp8 operands, accumulated in
    fp32, on ``route`` (default :func:`fp8_route`'s)."""
    route = fp8_route(a, b) if route is None else route
    if route == "scaled_mm":
        ku.require(fp8_route(a, b) == "scaled_mm",
                   f"fp8_matmul: scaled_mm takes CUDA operands with every "
                   f"dim % 16 == 0, not both e5m2; got {tuple(a.shape)} "
                   f"{a.dtype} @ {tuple(b.shape)} {b.dtype} on {a.device}")
        one = torch.ones((), dtype=torch.float32, device=a.device)
        return torch._scaled_mm(a.contiguous(), b.t().contiguous().t(),
                                scale_a=one, scale_b=one,
                                out_dtype=torch.float32,
                                use_fast_accum=False)
    if route != "upcast":
        raise ValueError(f"route must be 'scaled_mm' or 'upcast', got "
                         f"{route!r}")
    return torch.matmul(a.float(), b.float())


# ---------------------------------------------------------------------------
# the fp8 product: e4m3 forward operands, e5m2 backward cotangent


class _Fp8Dot(ku.OpaqueFunction):
    """JAX's ``_fp8_dot`` custom VJP; the backward also records the
    gradient half's new state into ``g_out``."""

    @staticmethod
    def forward(ctx, x, w, sx, sw, sg, g_hist, g_rate, g_out, recipe):
        qx = cast_fp8(x, sx, recipe.fwd_dtype)
        qw = cast_fp8(w, sw, recipe.fwd_dtype)
        y = fp8_matmul(qx.reshape(-1, x.shape[-1]), qw)
        y = y.reshape(*x.shape[:-1], w.shape[-1]) / (sx * sw)
        ctx.save_for_backward(qx, qw, sx, sw, sg, g_hist, g_rate)
        ctx.g_out, ctx.recipe = g_out, recipe
        return y

    @staticmethod
    def backward(ctx, dy):
        qx, qw, sx, sw, sg, g_hist, g_rate = ctx.saved_tensors
        recipe = ctx.recipe
        qdy = cast_fp8(dy, sg, recipe.grad_dtype)
        qdy2 = qdy.reshape(-1, dy.shape[-1])
        dx = fp8_matmul(qdy2, qw.t()).reshape(qx.shape) / (sg * sw)
        dw = fp8_matmul(qx.reshape(-1, qx.shape[-1]).t(), qdy2) / (sx * sg)
        amax_g, over_g = _observe(dy, sg, recipe.grad_dtype)
        new_g = update_tensor_state(Fp8TensorState(sg, g_hist, g_rate),
                                    amax_g, over_g, recipe.grad_dtype,
                                    recipe)
        for dst, src in zip(ctx.g_out, new_g):
            dst.copy_(src)
        return dx, dw, None, None, None, None, None, None, None


def fp8_dot(x: torch.Tensor, w: torch.Tensor, state: Fp8DotState,
            recipe: Fp8Recipe = Fp8Recipe()):
    """``x @ w`` with e4m3 operands (and an e5m2 gradient in backward),
    per-tensor delayed scaling. ``x``: (..., k); ``w``: (k, n); the result
    fp32. Returns ``(y, new_state)``: the x and w halves updated from this
    call's amaxes; the g half new tensors (state.g's values) that the
    backward overwrites with its update (module docstring)."""
    g_out = Fp8TensorState(*(t.detach().clone() for t in state.g))
    y = _Fp8Dot.apply(x.float(), w.float(), state.x.scale, state.w.scale,
                      state.g.scale, state.g.amax_history,
                      state.g.overflow_rate, g_out, recipe)
    amax_x, over_x = _observe(x, state.x.scale, recipe.fwd_dtype)
    amax_w, over_w = _observe(w, state.w.scale, recipe.fwd_dtype)
    new_state = Fp8DotState(
        x=update_tensor_state(state.x, amax_x, over_x, recipe.fwd_dtype,
                              recipe),
        w=update_tensor_state(state.w, amax_w, over_w, recipe.fwd_dtype,
                              recipe),
        g=g_out)
    return y, new_state


def _dot_states(tree, path=()):
    """``(path, Fp8DotState)`` pairs of a nested dict / list, in JAX's tree
    order."""
    if isinstance(tree, Fp8DotState):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _dot_states(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _dot_states(v, path + (str(i),))


def _map_dots(fn, tree, *rest):
    if isinstance(tree, Fp8DotState):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_dots(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_dots(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return tree


def merge_state_grads(fwd_states: Any, state_grads: Any = None) -> Any:
    """One step's new fp8 state: the forward halves from :func:`fp8_dot`'s
    outputs and the gradient halves its backward recorded there; with
    ``state_grads`` (a tree of states shaped like JAX's cotangent), the g
    halves are taken from it, as JAX's merge does."""
    if state_grads is None:
        return fwd_states
    return _map_dots(lambda f, g: Fp8DotState(f.x, f.w, g.g), fwd_states,
                     state_grads)


# ---------------------------------------------------------------------------
# policy declaration + telemetry + checkpointing


def fp8_policy():
    """The amp-side declaration: ``get_policy("FP8")``."""
    from apex_tpu_torch.amp.frontend import get_policy

    return get_policy("FP8")


def fp8_metrics(state: Any, prefix: str = "fp8") -> Dict[str, Any]:
    """Per-site scales and amaxes and the headline
    ``{prefix}_overflow_rate`` (the largest saturated fraction of any
    cast site), as 0-d tensors for ``monitor.metrics.Metrics``."""
    out: Dict[str, Any] = {}
    rates = []
    for path, leaf in _dot_states(state):
        name = "/".join(path) or "dot"
        for half in ("x", "w", "g"):
            ts: Fp8TensorState = getattr(leaf, half)
            out[f"{prefix}_{name}_{half}_scale"] = ts.scale
            out[f"{prefix}_{name}_{half}_amax"] = torch.max(ts.amax_history)
            rates.append(ts.overflow_rate)
    if rates:
        out[f"{prefix}_overflow_rate"] = torch.max(torch.stack(rates))
    return out


def _flatten(tree):
    """(leaves, structure string) of a tree of dicts, lists and the state
    NamedTuples (JAX's tree order and the role of its treedef)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [_flatten(v) for v in tree]
        return ([x for p in parts for x in p[0]],
                f"{type(tree).__name__}({', '.join(p[1] for p in parts)})")
    if isinstance(tree, dict):
        parts = [(k, _flatten(tree[k])) for k in sorted(tree)]
        return ([x for _, p in parts for x in p[0]],
                "{" + ", ".join(f"{k!r}: {p[1]}" for k, p in parts) + "}")
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        return ([x for p in parts for x in p[0]],
                "[" + ", ".join(p[1] for p in parts) + "]")
    return [tree], "*"


def _unflatten(tree, leaves):
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rebuild(v) for v in node))
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    return rebuild(tree)


def state_dict(state: Any) -> Dict[str, Any]:
    """Flat serialization: leaves (CPU tensors) keyed by flat index and the
    structure string, so a resume against another structure fails
    loudly."""
    leaves, treedef = _flatten(state)
    return {"treedef": treedef,
            "leaves": {str(i): x.detach().cpu().clone()
                       for i, x in enumerate(leaves)}}


def load_state_dict(state_template: Any, d: Dict[str, Any]) -> Any:
    """Restore onto the live structure (each leaf on the template's device
    and dtype); refuses another structure, leaf count or leaf shape."""
    leaves, treedef = _flatten(state_template)
    if d.get("treedef") is not None and d["treedef"] != treedef:
        raise ValueError(
            "fp8 state does not match the live structure:\n"
            f"  saved: {d['treedef']}\n  live:  {treedef}")
    if len(d["leaves"]) != len(leaves):
        raise ValueError(
            f"fp8 state has {len(d['leaves'])} saved leaves, live "
            f"structure has {len(leaves)}")
    new = []
    for i, want in enumerate(leaves):
        got = torch.as_tensor(d["leaves"][str(i)]).to(device=want.device,
                                                      dtype=want.dtype)
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(
                f"fp8 state leaf {i} shape mismatch: saved "
                f"{tuple(got.shape)}, live {tuple(want.shape)}")
        new.append(got)
    return _unflatten(state_template, new)
