"""Model-parallel amp (counterpart of ``apex_tpu/transformer/amp``)."""

from apex_tpu_torch.transformer.amp.grad_scaler import GradScaler  # noqa: F401
