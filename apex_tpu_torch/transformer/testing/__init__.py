"""Test/flagship models of the port (counterpart of
``apex_tpu/transformer/testing``)."""

from apex_tpu_torch.transformer.testing.standalone_gpt import (  # noqa: F401
    GPTConfig,
    embed_tokens,
    gpt_forward,
    gpt_head,
    gpt_loss,
    init_gpt_params,
    tied_vocab_logits,
)
from apex_tpu_torch.transformer.testing.train import (  # noqa: F401
    build_train_step,
)
