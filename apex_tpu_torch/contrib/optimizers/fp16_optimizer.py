"""Contrib ``FP16_Optimizer`` (counterpart of
``apex_tpu/contrib/optimizers/fp16_optimizer.py``; reference
``apex/contrib/optimizers/fp16_optimizer.py``). The contrib variant
differs from ``fp16_utils.FP16_Optimizer`` only in taking explicit
gradients and output params for the reference's legacy fused kernels;
under the functional surface both are the same wrapper, re-exported
here as JAX does."""

from apex_tpu_torch.fp16_utils.fp16_optimizer import FP16_Optimizer  # noqa: F401

__all__ = ["FP16_Optimizer"]
