"""Test/flagship models of the port (counterpart of
``apex_tpu/transformer/testing``): GPT, T5 and BERT, their training steps
and their pipeline wiring."""

from apex_tpu_torch.transformer.testing.standalone_bert import (  # noqa: F401
    BertConfig,
    bert_forward,
    bert_param_specs,
    bert_mlm_loss,
    init_bert_params,
    init_bert_params_numpy,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (  # noqa: F401
    GPTConfig,
    dots_attn_policy,
    embed_tokens,
    gather_grads,
    gpt_forward,
    gpt_head,
    gpt_loss,
    gpt_param_specs,
    gpt_params_from_numpy,
    gpt_pipeline_params,
    gpt_pipeline_params_numpy,
    gpt_pipeline_spec,
    gpt_pipeline_specs_tree,
    init_gpt_params,
    shard_params,
    tied_vocab_logits,
)
from apex_tpu_torch.transformer.testing.standalone_t5 import (  # noqa: F401
    T5Config,
    init_t5_params,
    init_t5_params_numpy,
    t5_decode,
    t5_encode,
    t5_loss,
    t5_enc_dec_spec,
    t5_param_specs,
    t5_pipeline_params,
    t5_pipeline_params_numpy,
    t5_pipeline_specs_tree,
    t5_relative_bias,
)
from apex_tpu_torch.transformer.testing.train import (  # noqa: F401
    build_t5_train_step,
    build_train_step,
)
