"""Stage-to-stage activation exchange over the pipeline mesh axis
(counterpart of ``apex_tpu/transformer/pipeline_parallel/
p2p_communication.py``).

Reference Apex batches ``isend`` / ``irecv`` between adjacent stages and
exposes eight ops. JAX collapses them onto two ring shifts
(``lax.ppermute``): +1 along ``pp`` for activations, -1 for cotangents.
The port keeps JAX's semantics: every rank of the pp group calls the same
op, each sends its value one way round the ring and receives its
neighbour's (``comm.overlap.ring_shift``: one ``batch_isend_irecv`` hop,
entered into the open accounting records as a ``collective-permute``).
The hop is differentiable: its backward shifts the cotangent the other
way, so autograd through a forward shift is the backward pipeline's
traffic. The ring wraps: the last stage's value arrives at stage 0.

The ``send_*`` / ``recv_*`` names are JAX's aliases of the two shifts:
they take and return a nested dict / tuple / list of tensors, and each
returns the shifted value. On a pp axis of one rank every shift returns
its input and issues no collective, as the tp mappings do.

``scatter_gather=True`` (the reference's
``scatter_gather_tensors_in_pipeline``): each tp rank hops only its 1/tp
slice of the last dim and the tp group all-gathers the slices after the
hop (the tp mappings' split and gather, so the backward is the same shift
of the cotangent).
"""

from __future__ import annotations

from apex_tpu_torch.comm.overlap import ring_shift
from apex_tpu_torch.optimizers._common import tree_map
from apex_tpu_torch.parallel.mesh import PP_AXIS, TP_AXIS, axis_info
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    gather_from_tensor_model_parallel_region,
    scatter_to_tensor_model_parallel_region,
)

_NAME = "pp_ring_shift"


def _shift(x, shift: int, axis_name: str):
    return tree_map(lambda a: ring_shift(a, axis_name, shift, _NAME), x)


def send_forward_recv_forward(output_tensor, axis_name: str = PP_AXIS, *,
                              scatter_gather: bool = False):
    """Hand this stage's output to the next stage and receive the previous
    stage's (ref p2p_communication.py:350-372); ring-wrapped."""
    if scatter_gather:
        return _scatter_shift_gather(output_tensor, +1, axis_name)
    return _shift(output_tensor, +1, axis_name)


def send_backward_recv_backward(input_tensor_grad, axis_name: str = PP_AXIS):
    """Hand this stage's input gradient to the previous stage (ref
    :373-395): the shift autograd runs for a forward shift's backward."""
    return _shift(input_tensor_grad, -1, axis_name)


def send_forward(output_tensor, axis_name: str = PP_AXIS):
    """Ref :237-263."""
    return send_forward_recv_forward(output_tensor, axis_name)


def recv_forward(output_tensor_from_prev, axis_name: str = PP_AXIS):
    """Ref :187-212: every stage passes the value it computed and gets the
    previous stage's."""
    return send_forward_recv_forward(output_tensor_from_prev, axis_name)


def send_backward(input_tensor_grad, axis_name: str = PP_AXIS):
    """Ref :264-290."""
    return send_backward_recv_backward(input_tensor_grad, axis_name)


def recv_backward(grad_from_next, axis_name: str = PP_AXIS):
    """Ref :213-236."""
    return send_backward_recv_backward(grad_from_next, axis_name)


def send_forward_recv_backward(output_tensor, grad_tensor,
                               axis_name: str = PP_AXIS):
    """Ref :291-319, the 1F1B steady-state exchange: activations up,
    cotangents down. Returns ``(recv_forward_value,
    recv_backward_value)``."""
    return (_shift(output_tensor, +1, axis_name),
            _shift(grad_tensor, -1, axis_name))


def send_backward_recv_forward(input_tensor_grad, output_tensor,
                               axis_name: str = PP_AXIS):
    """Ref :320-349. Returns ``(recv_backward_value,
    recv_forward_value)``."""
    return (_shift(input_tensor_grad, -1, axis_name),
            _shift(output_tensor, +1, axis_name))


def _scatter_shift_gather(x, shift: int, axis_name: str,
                          tp_axis: str = TP_AXIS):
    """Shift 1/tp of the last dim per tp rank, then all-gather it over tp
    (ref p2p_communication.py:100-186). A leaf whose last dim tp does not
    divide hops whole."""

    def one(a):
        tp = axis_info(tp_axis)[1]
        if tp == 1 or a.shape[-1] % tp != 0:
            return ring_shift(a, axis_name, shift, _NAME)
        piece = scatter_to_tensor_model_parallel_region(a, tp_axis)
        piece = ring_shift(piece, axis_name, shift, _NAME)
        return gather_from_tensor_model_parallel_region(piece, tp_axis)

    return tree_map(one, x)
