"""Model-parallel state (counterpart of
``apex_tpu/transformer/parallel_state.py``): the mesh-backed analogue of
Megatron's process groups.

:func:`initialize_model_parallel` builds the port's 4-axis
:class:`~apex_tpu_torch.parallel.mesh.Mesh` over the default process
group (JAX's rank layout, ``np.reshape(ranks, (dp, pp, sp, tp))``) and
installs it as the current mesh; the rest is the JAX module's
bookkeeping: the world-size accessors, the encoder/decoder split rank,
the virtual-pipeline rank and size, and the axis-name exports (the
"process group" handles: a collective of the port takes the name).

The rank accessors return this process's coordinate on the axis
(``mesh.index(axis)``) as a Python int, as reference Apex returns its
NCCL rank. JAX returns ``lax.axis_index(axis)``, a traced value valid
only inside a mesh program, because one SPMD program runs on every
device there; here every rank is its own process, so the rank is known
on the host and the stage predicates are Python booleans.
"""

from __future__ import annotations

from typing import Optional, Sequence

from apex_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    DP_AXIS,
    PP_AXIS,
    SP_AXIS,
    TP_AXIS,
    Mesh,
    build_mesh,
    model_parallel_axes,
    set_mesh,
)

_MESH: Optional[Mesh] = None
_VIRTUAL_PP_SIZE: Optional[int] = None
_VIRTUAL_PP_RANK: Optional[int] = None
_PP_SPLIT_RANK: Optional[int] = None


def initialize_model_parallel(
    tensor_model_parallel_size_: int = 1,
    pipeline_model_parallel_size_: int = 1,
    virtual_pipeline_model_parallel_size_: Optional[int] = None,
    sequence_parallel_size_: int = 1,
    pipeline_model_parallel_split_rank_: Optional[int] = None,
    *,
    devices: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build and install the mesh (dp takes the remaining ranks); returns
    it. ``torch.distributed`` must be initialized
    (``parallel.multiproc.initialize_distributed`` or ``spawn``). The
    split rank is the encoder/decoder boundary, bookkeeping as in JAX;
    it must lie in (0, pp)."""
    global _MESH, _VIRTUAL_PP_SIZE, _VIRTUAL_PP_RANK, _PP_SPLIT_RANK
    if pipeline_model_parallel_split_rank_ is not None and not (
            0 < pipeline_model_parallel_split_rank_
            < pipeline_model_parallel_size_):
        raise ValueError(
            f"pipeline_model_parallel_split_rank_="
            f"{pipeline_model_parallel_split_rank_} outside "
            f"(0, pp={pipeline_model_parallel_size_})")
    _MESH = build_mesh(tp=tensor_model_parallel_size_,
                       pp=pipeline_model_parallel_size_,
                       sp=sequence_parallel_size_, devices=devices)
    _VIRTUAL_PP_SIZE = virtual_pipeline_model_parallel_size_
    _VIRTUAL_PP_RANK = 0 if virtual_pipeline_model_parallel_size_ else None
    _PP_SPLIT_RANK = pipeline_model_parallel_split_rank_
    return _MESH


def model_parallel_is_initialized() -> bool:
    return _MESH is not None


def get_mesh() -> Mesh:
    if _MESH is None:
        raise RuntimeError(
            "model parallel mesh is not initialized; call "
            "initialize_model_parallel() first")
    return _MESH


def destroy_model_parallel() -> None:
    """Forget the mesh and the bookkeeping, and uninstall the mesh if it
    is the current one."""
    global _MESH, _VIRTUAL_PP_SIZE, _VIRTUAL_PP_RANK, _PP_SPLIT_RANK
    from apex_tpu_torch.parallel.mesh import get_mesh as current

    if _MESH is not None and current(required=False) is _MESH:
        set_mesh(None)
    _MESH = None
    _VIRTUAL_PP_SIZE = None
    _VIRTUAL_PP_RANK = None
    _PP_SPLIT_RANK = None


def get_mesh_axes_str() -> str:
    if _MESH is None:
        return "uninitialized"
    return "x".join(f"{a}={_MESH.shape[a]}" for a in AXIS_ORDER)


# ---------------------------------------------------------------------------
# world sizes


def get_tensor_model_parallel_world_size() -> int:
    return get_mesh().shape[TP_AXIS]


def get_pipeline_model_parallel_world_size() -> int:
    return get_mesh().shape[PP_AXIS]


def get_sequence_parallel_world_size() -> int:
    return get_mesh().shape[SP_AXIS]


def get_data_parallel_world_size() -> int:
    return get_mesh().shape[DP_AXIS]


def get_model_parallel_world_size() -> int:
    m = get_mesh()
    out = 1
    for a in model_parallel_axes(m):
        out *= m.shape[a]
    return out


# ---------------------------------------------------------------------------
# ranks (this process's coordinates, Python ints)


def get_tensor_model_parallel_rank() -> int:
    return get_mesh().index(TP_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return get_mesh().index(PP_AXIS)


def get_sequence_parallel_rank() -> int:
    return get_mesh().index(SP_AXIS)


def get_data_parallel_rank() -> int:
    return get_mesh().index(DP_AXIS)


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    """The first stage; with a virtual pipeline, only while the virtual
    rank is 0 (its first chunk holds the model's first layer)."""
    first = get_pipeline_model_parallel_rank() == 0
    if not ignore_virtual and _VIRTUAL_PP_SIZE is not None:
        return first and _VIRTUAL_PP_RANK == 0
    return first


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    last = (get_pipeline_model_parallel_rank()
            == get_pipeline_model_parallel_world_size() - 1)
    if not ignore_virtual and _VIRTUAL_PP_SIZE is not None:
        return last and _VIRTUAL_PP_RANK == _VIRTUAL_PP_SIZE - 1
    return last


# ---------------------------------------------------------------------------
# encoder/decoder split


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    return _PP_SPLIT_RANK


def set_pipeline_model_parallel_split_rank(rank: int) -> None:
    global _PP_SPLIT_RANK
    _PP_SPLIT_RANK = rank


def is_pipeline_stage_before_split(rank: Optional[int] = None) -> bool:
    """Whether the stage runs encoder blocks; True when pp == 1 or no split
    rank is set."""
    if get_pipeline_model_parallel_world_size() == 1 or _PP_SPLIT_RANK is None:
        return True
    if rank is None:
        rank = get_pipeline_model_parallel_rank()
    return rank < _PP_SPLIT_RANK


def is_pipeline_stage_after_split(rank: Optional[int] = None) -> bool:
    """Whether the stage runs decoder blocks; True when pp == 1 or no split
    rank is set."""
    if get_pipeline_model_parallel_world_size() == 1 or _PP_SPLIT_RANK is None:
        return True
    if rank is None:
        rank = get_pipeline_model_parallel_rank()
    return rank >= _PP_SPLIT_RANK


def is_pipeline_stage_at_split() -> bool:
    """The last encoder stage; False when pp == 1 or no split rank is
    set."""
    if get_pipeline_model_parallel_world_size() == 1 or _PP_SPLIT_RANK is None:
        return False
    rank = get_pipeline_model_parallel_rank()
    return (is_pipeline_stage_before_split(rank)
            and is_pipeline_stage_after_split(rank + 1))


# ---------------------------------------------------------------------------
# virtual pipeline


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PP_SIZE


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _VIRTUAL_PP_RANK


def set_virtual_pipeline_model_parallel_rank(rank: int) -> None:
    global _VIRTUAL_PP_RANK
    _VIRTUAL_PP_RANK = rank


# ---------------------------------------------------------------------------
# axis names (the "process group" handles)


def get_tensor_model_parallel_axis() -> str:
    return TP_AXIS


def get_pipeline_model_parallel_axis() -> str:
    return PP_AXIS


def get_sequence_parallel_axis() -> str:
    return SP_AXIS


def get_data_parallel_axis() -> str:
    return DP_AXIS


def get_model_parallel_axes():
    return model_parallel_axes(get_mesh())


def get_rank_info() -> str:
    """The mesh's shape for logging."""
    if _MESH is None:
        return "mesh uninitialized"
    return get_mesh_axes_str()
