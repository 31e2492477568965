"""Contrib layer of the port (counterpart of ``apex_tpu/contrib``): so far
``contrib.fmha``, packed variable-length attention over the varlen flash
kernels, ``contrib.layer_norm``, FastLayerNorm over the LayerNorm
kernels, ``contrib.xentropy``, the label-smoothing cross-entropy,
``contrib.multihead_attn``, the self and encoder-decoder attention
modules over LayerNorm and flash, ``contrib.transducer``, the RNN-T
joint and loss, and ``contrib.sparsity``, ASP's 2:4 masks, the
channel-permutation search and the pruned optimizer step, and
``contrib.optimizers``, ZeRO's ``DistributedFusedAdam`` and
``DistributedFusedLAMB`` over dp-sharded state."""
