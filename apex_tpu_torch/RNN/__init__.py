"""Fused-gate RNN stack (counterpart of ``apex_tpu/RNN``): LSTM, GRU, the
tanh / ReLU RNNs (stacked, bidirectional, dropout between layers) and the
multiplicative LSTM."""

from apex_tpu_torch.RNN.models import (  # noqa: F401
    GRU,
    LSTM,
    RNNReLU,
    RNNTanh,
    mLSTM,
)

__all__ = ["LSTM", "GRU", "RNNReLU", "RNNTanh", "mLSTM"]
