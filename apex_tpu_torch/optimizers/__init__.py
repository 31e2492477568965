"""Optimizers of the port (counterpart of ``apex_tpu/optimizers``):
``torch.optim.Optimizer`` subclasses with JAX's update math and fp32
state. FusedAdam's tail is a CUDA kernel per leaf on the card (B #15);
the others run plain torch ops, as JAX runs XLA op chains."""

from apex_tpu_torch.optimizers._common import (  # noqa: F401
    Schedule,
    apply_updates,
    global_norm,
    value_at,
)
from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad  # noqa: F401
from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedMixedPrecisionLamb,
)
from apex_tpu_torch.optimizers.fused_novograd import (  # noqa: F401
    FusedNovoGrad,
)
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD  # noqa: F401
from apex_tpu_torch.optimizers.grad_accumulation import (  # noqa: F401
    accumulate_gradients,
    accumulate_into_main_grads,
    init_main_grads,
)
from apex_tpu_torch.parallel.larc import LARC, larc_transform  # noqa: F401

__all__ = [
    "accumulate_gradients",
    "accumulate_into_main_grads",
    "init_main_grads",
    "FusedAdam",
    "FusedAdagrad",
    "FusedLAMB",
    "FusedMixedPrecisionLamb",
    "FusedNovoGrad",
    "FusedSGD",
    "LARC",
    "apply_updates",
    "global_norm",
    "larc_transform",
]
