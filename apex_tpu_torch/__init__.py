"""apex_tpu_torch — the PyTorch/CUDA port of ``apex_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package keeps its module and
function names so each piece has an obvious counterpart. Plain tensor code
is PyTorch; every Pallas kernel on a ported path is a CUDA C++ kernel for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use and launched
through ``ctypes`` (``ops._kernel_util``). Each kernel's plain PyTorch
version sits beside its wrapper and runs only for tensors on the CPU.

Ported so far: the single-engine serving path (``serve``: the fused
per-layer decode/verify kernel, the per-op path with the LayerNorm and
paged-attention kernels, int8/int4 paged KV through ``comm.quantize``'s
codec), the GPT-2-124M and T5-small train steps (``transformer.testing``,
``ops``, ``optimizers``), packed variable-length attention
(``contrib.fmha`` over ``ops.attention_varlen``), the engine's latency
histograms (``monitor.hist``), the LayerNorm / RMSNorm modules
(``normalization``, ``contrib.layer_norm``), the blockwise codec's
kernels (``comm.quantize``), GPT's and T5's dropout under JAX's threefry
keys with the remat policies (``transformer.tensor_parallel.random``,
``ops.dropout``: a CUDA kernel with no Pallas counterpart), and the
Megatron functional ops (``ops.softmax``,
``transformer.functional``, ``ops.xentropy``, ``contrib.xentropy``,
``mlp``, ``fused_dense``), mixed precision (``amp``, the optimizer
suite, ``fp16_utils``; every kernel a training path reaches takes fp32,
bf16 and fp16; so do the serving kernels and the codec), BERT
(``transformer.testing.standalone_bert``), the
``contrib.multihead_attn``, ``contrib.transducer`` and
``contrib.sparsity`` (ASP) modules, the example models (``models``:
ResNet over ``parallel.sync_batchnorm``'s one-device path, DCGAN),
``RNN``, ``reparameterization`` and ``_autocast_utils``: every Pallas
kernel of ``apex_tpu`` has its CUDA counterpart. Data parallelism rides
``torch.distributed``: the mesh (``parallel.mesh``), process bootstrap
(``parallel.multiproc``), the compressed collectives over the codec
kernels with error feedback (``comm.collectives``,
``comm.error_feedback``, ``comm.accounting``), DDP
(``parallel.distributed``), SyncBatchNorm across devices,
``contrib.groupbn`` and ``contrib.bottleneck``.
"""

from apex_tpu_torch._device import resolve_device  # noqa: F401

__version__ = "0.1.0"
