"""apex_tpu_torch.comm (counterpart of ``apex_tpu.comm``): the blockwise
codec (``quantize``, with its kernels in ``csrc/quantize.cu``), the
compressed all-reduce and reduce-scatter over ``torch.distributed``
(``collectives``), the error-feedback residual (``error_feedback``),
the bytes-on-wire record of the issued collectives (``accounting``)
and ``overlap``, the decomposed collective matmuls (their rings'
record: ``accounting.record_overlap`` / ``overlap_report``)."""

from apex_tpu_torch.comm.accounting import (  # noqa: F401
    CollectiveReport,
    OverlapReport,
    collective_report,
    overlap_report,
    record_collectives,
    record_overlap,
    wire_bytes,
)
from apex_tpu_torch.comm.collectives import (  # noqa: F401
    CompressionConfig,
    all_gather_wire_bytes,
    allreduce_wire_bytes,
    compressed_allreduce,
    compressed_psum_scatter,
    psum_scatter_wire_bytes,
)
from apex_tpu_torch.comm.error_feedback import (  # noqa: F401
    init_error_feedback,
    load_state_dict,
    state_dict,
)
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
