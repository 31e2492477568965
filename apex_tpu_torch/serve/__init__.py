"""apex_tpu_torch.serve — the single-engine serving path on PyTorch/CUDA
(counterpart of ``apex_tpu.serve``):

* :mod:`~apex_tpu_torch.serve.kv_cache` — paged K/V pools updated in
  place (plus a trash block for dropped writes), full precision or int8 /
  int4 through the ``comm.quantize`` codec, the refcounted
  :class:`BlockAllocator` with prefix caching, copy-on-write, byte models;
* :mod:`~apex_tpu_torch.serve.decode` — paged attention (plain version +
  the ``csrc/paged_attention.cu`` kernel) and the serve programs
  ``gpt_paged_forward`` / ``gpt_decode_step`` / ``gpt_verify_step`` /
  ``gpt_prefill_chunk``;
* :mod:`~apex_tpu_torch.serve.megakernel` — the fused per-layer decode /
  verify kernel (``csrc/megakernel.cu``), its plain version, the fused
  serve programs and the shape gate;
* :mod:`~apex_tpu_torch.serve.sampling` — greedy / temperature / top-k /
  top-p with counter-hash position-keyed draws;
* :mod:`~apex_tpu_torch.serve.drafter` — prompt-lookup n-gram drafter;
* :mod:`~apex_tpu_torch.serve.adapters` — per-tenant paged LoRA: the
  adapter pool, the gathered ``lora_delta``, the merged-weight oracle and
  the :class:`AdapterRegistry`;
* :mod:`~apex_tpu_torch.serve.engine` — the continuous-batching
  :class:`InferenceEngine` (chunked prefill, prefix cache, speculative
  decode, adapters, the ``monitor`` telemetry, slot eviction; one rank of
  a tensor-parallel group with ``tp_axis``);
* :mod:`~apex_tpu_torch.serve.sharded` — plan-driven model-parallel
  serving: :func:`build_engine` reads ``ServeConfig.plan`` (tp shards,
  the :class:`PPStagedEngine`, fsdp weight residency).
"""

from apex_tpu_torch.serve.adapters import (  # noqa: F401
    ADAPTER_TARGETS,
    AdapterRegistry,
    adapter_pool_bytes,
    init_adapter_pool,
    lora_delta,
    make_adapter_weights,
    merge_adapter_params,
    write_adapter,
)

from apex_tpu_torch.serve.decode import (  # noqa: F401
    gpt_decode_step,
    gpt_paged_forward,
    gpt_prefill_chunk,
    gpt_verify_step,
    paged_attention,
    paged_attention_fwd,
    paged_attention_reference,
    paged_layer_stack,
    serve_logits,
)
from apex_tpu_torch.serve.drafter import Drafter, NGramDrafter  # noqa: F401
from apex_tpu_torch.serve.engine import (  # noqa: F401
    InferenceEngine,
    Request,
    ServeConfig,
    decode_flops_per_token,
)
from apex_tpu_torch.serve.kv_cache import (  # noqa: F401
    BlockAllocator,
    KVCacheConfig,
    copy_block,
    gather_kv,
    hash_block_tokens,
    init_kv_cache,
    kv_cache_bytes,
    kv_read_bytes,
    kv_write_bytes_per_token,
    paged_write,
    prefix_block_hashes,
)
from apex_tpu_torch.serve.megakernel import (  # noqa: F401
    fused_layer_decode,
    fused_layer_reference,
    fused_layer_verify,
    gpt_decode_step_fused,
    gpt_verify_step_fused,
    megakernel_ok,
    megakernel_refusal,
)
from apex_tpu_torch.serve.sharded import (  # noqa: F401
    PPStagedEngine,
    build_engine,
    plan_world,
)
from apex_tpu_torch.serve.sampling import (  # noqa: F401
    SamplingConfig,
    request_key,
    sample,
)
