"""Contrib layer of the port (counterpart of ``apex_tpu/contrib``): so far
``contrib.fmha``, packed variable-length attention over the varlen flash
kernels, ``contrib.layer_norm``, FastLayerNorm over the LayerNorm
kernels, and ``contrib.xentropy``, the label-smoothing cross-entropy."""
