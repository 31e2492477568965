"""Mixed precision (counterpart of ``apex_tpu/amp``): the opt levels O0-O3
and FP8 as policies (:func:`initialize`, :func:`get_policy`), the O1
per-op :func:`autocast`, dynamic loss scaling with a device-side skip
(:func:`scale_loss`, :func:`apply_grads`,
:func:`apply_grads_with_optimizer`, :class:`LossScaler`), the
registration decorators, checkpointing, and :mod:`.fp8`."""

from apex_tpu_torch.amp import fp8  # noqa: F401
from apex_tpu_torch.amp.autocast import (  # noqa: F401
    autocast,
    float_function,
    half_function,
    promote_function,
)
from apex_tpu_torch.amp.frontend import (  # noqa: F401
    AmpState,
    apply_grads,
    apply_grads_with_optimizer,
    cast_inputs,
    cast_params,
    default_norm_predicate,
    get_policy,
    initialize,
    load_state_dict,
    model_params,
    policy_compute_dtype,
    scale_loss,
    state_dict,
    trainable_leaves,
)
from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState  # noqa: F401

__all__ = [
    "AmpState",
    "LossScaler",
    "LossScalerState",
    "apply_grads",
    "apply_grads_with_optimizer",
    "autocast",
    "cast_inputs",
    "cast_params",
    "default_norm_predicate",
    "float_function",
    "fp8",
    "get_policy",
    "half_function",
    "initialize",
    "load_state_dict",
    "model_params",
    "policy_compute_dtype",
    "promote_function",
    "scale_loss",
    "state_dict",
]
