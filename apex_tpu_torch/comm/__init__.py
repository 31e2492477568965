"""apex_tpu_torch.comm — so far the blockwise codec (counterpart of
``apex_tpu.comm.quantize``, with its quantize and dequantize kernels in
``csrc/quantize.cu``) that the quantized KV cache uses; the collectives
are ROADMAP §A item 7."""

from apex_tpu_torch.comm.quantize import (  # noqa: F401
    QMAX,
    QMAX4,
    blocks_for,
    dequantize_blockwise,
    dequantize_blockwise_int4,
    pack_int4,
    padded_size,
    qmax_for_bits,
    quantization_error,
    quantization_error_int4,
    quantize_blockwise,
    quantize_blockwise_int4,
    unpack_int4,
)
