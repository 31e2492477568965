"""Legacy manual mixed-precision helpers (counterpart of
``apex_tpu/fp16_utils``): module-tree casting, the fp32 master-param
bookkeeping, the static and dynamic loss scalers and the
``FP16_Optimizer`` wrapper, over the port's :mod:`apex_tpu_torch.amp`
scaler and optimizers."""

from apex_tpu_torch.fp16_utils.fp16util import (  # noqa: F401
    clip_grad_norm,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    to_python_float,
)
from apex_tpu_torch.fp16_utils.fp16_optimizer import (  # noqa: F401
    FP16_Optimizer,
    FP16OptimizerState,
)
from apex_tpu_torch.fp16_utils.loss_scaler import (  # noqa: F401
    DynamicLossScaler,
    LossScaler,
)

__all__ = [
    "network_to_half",
    "convert_network",
    "prep_param_lists",
    "model_grads_to_master_grads",
    "master_params_to_model_params",
    "clip_grad_norm",
    "to_python_float",
    "FP16_Optimizer",
    "FP16OptimizerState",
    "LossScaler",
    "DynamicLossScaler",
]
