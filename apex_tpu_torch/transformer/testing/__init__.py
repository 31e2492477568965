"""Test/flagship models of the port (counterpart of
``apex_tpu/transformer/testing``)."""

from apex_tpu_torch.transformer.testing.standalone_gpt import (  # noqa: F401
    GPTConfig,
    init_gpt_params,
)
