"""Transformer models of the port (counterpart of ``apex_tpu/transformer``)."""
