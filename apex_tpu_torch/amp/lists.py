"""Per-function cast tables of the O1 autocast (counterpart of
``apex_tpu/amp/lists.py``).

JAX classifies **primitives** (its autocast re-evaluates a jaxpr); eager
PyTorch has no trace, so the port classifies **torch functions** by name
(the ``torch.*`` function, the ``Tensor`` method and the
``torch.nn.functional`` entry share one), with the output dtype each has
under JAX's autocast of its ``jnp`` counterpart:

* :data:`FP16_FUNCS` — products (JAX's ``dot_general`` / ``conv``): float
  inputs cast to the compute dtype, the product in it. A bias or an added
  input (``linear``, ``addmm``, ``conv*``) is added after the product at
  the wider of the two dtypes, as JAX's ``dot`` then ``add``.
* :data:`FP32_FUNCS` — functions whose JAX counterpart reaches a listed
  primitive (exp / log family, ``logistic``, ``pow``, ``rsqrt``, ``erf``,
  cumulative sums): float inputs cast to fp32, the result fp32. A torch
  composite is listed when its ``jnp`` decomposition reaches one:
  ``softmax`` (``exp``), ``silu`` (``logistic``), exact ``gelu``
  (``erf``). Not listed, because JAX's result keeps the input dtype:
  ``sum``, ``mean``, ``var``, ``prod``, ``norm`` (``jnp`` upcasts inside
  and casts back explicitly), a mean cross entropy (its ``jnp`` mean casts
  back), ``tanh``, ``sqrt``, tanh-``gelu``, ``softplus`` (a custom-JVP
  region in JAX), an integer power. Where a ``jnp`` composite keeps part
  of its work in the input's half type (``log10``'s constant, softmax's
  max shift) the values differ by that rounding.
* everything else: mixed float tensor inputs promoted to the widest
  (0-d tensors included, as JAX promotes them), a single one left alone.

Never rewritten: explicit conversions (:data:`CONVERSIONS` and any call
with a ``dtype=``), in-place methods, and the port's custom-gradient
regions (``_kernel_util.OpaqueFunction``: flash, LayerNorm / RMSNorm, the
LM-head loss, dropout, the softmaxes and cross entropies), which run with
their float inputs at the dtypes they would have had without autocast,
as JAX binds its ``custom_vjp`` regions at their traced dtypes.
"""

from __future__ import annotations

FP16_FUNCS = frozenset({
    "matmul", "__matmul__", "__rmatmul__", "mm", "bmm", "mv", "dot",
    "einsum", "tensordot", "linear", "addmm", "baddbmm", "conv1d",
    "conv2d", "conv3d",
})

FP32_FUNCS = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sigmoid",
    "rsqrt", "erf", "erfc", "erfinv", "acos", "acosh", "asin", "asinh",
    "atan", "atanh", "atan2", "cosh", "sinh", "tan", "digamma", "lgamma",
    "cumsum", "cumprod", "logcumsumexp", "softmax", "log_softmax",
    "logsumexp", "silu",
})

# explicit conversions: the caller chose the dtype
CONVERSIONS = frozenset({
    "to", "type", "type_as", "float", "double", "half", "bfloat16",
})

# functions whose listing depends on an argument (autocast.py decides):
# pow (a float or tensor exponent is JAX's ``pow``, an int its
# ``integer_pow``), gelu (exact: ``erf``; tanh: neither)
CONDITIONAL = frozenset({"pow", "__pow__", "__rpow__", "gelu"})
