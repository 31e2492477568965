"""Contrib xentropy (counterpart of ``apex_tpu/contrib/xentropy``): the
label-smoothing cross-entropy of ``apex_tpu_torch.ops.xentropy`` under the
reference's contrib name."""

from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss  # noqa: F401

SoftmaxCrossEntropyLoss = softmax_cross_entropy_loss

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy_loss"]
