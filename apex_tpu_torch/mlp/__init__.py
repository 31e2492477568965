"""The fused MLP (counterpart of ``apex_tpu/mlp``)."""

from apex_tpu_torch.mlp.mlp import MLP, mlp_forward  # noqa: F401

__all__ = ["MLP", "mlp_forward"]
