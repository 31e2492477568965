"""Test/flagship models of the port (counterpart of
``apex_tpu/transformer/testing``)."""

from apex_tpu_torch.transformer.testing.standalone_bert import (  # noqa: F401
    BertConfig,
    bert_forward,
    bert_mlm_loss,
    init_bert_params,
    init_bert_params_numpy,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (  # noqa: F401
    GPTConfig,
    dots_attn_policy,
    embed_tokens,
    gpt_forward,
    gpt_head,
    gpt_loss,
    init_gpt_params,
    tied_vocab_logits,
)
from apex_tpu_torch.transformer.testing.standalone_t5 import (  # noqa: F401
    T5Config,
    init_t5_params,
    init_t5_params_numpy,
    t5_decode,
    t5_encode,
    t5_loss,
    t5_relative_bias,
)
from apex_tpu_torch.transformer.testing.train import (  # noqa: F401
    build_t5_train_step,
    build_train_step,
)
