"""ASP — automatic 2:4 structured sparsity (counterpart of
``apex_tpu/contrib/sparsity``): N:M masks, the channel-permutation search
and the mask bookkeeping around a port optimizer."""

from apex_tpu_torch.contrib.sparsity.asp import ASP  # noqa: F401
from apex_tpu_torch.contrib.sparsity.sparse_masklib import (  # noqa: F401
    create_mask,
)

__all__ = ["ASP", "create_mask"]
