"""The device mesh over ``torch.distributed`` (counterpart of
``apex_tpu/parallel/mesh.py``).

JAX builds one ``jax.sharding.Mesh`` with named axes and passes an axis
name to every collective. The port keeps the names and the layout: a
:class:`Mesh` wraps a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the default process group, with ``AXIS_ORDER``'s dims, and
an axis name resolves to that dim's process group, its size and this
rank's index on it (what ``lax.axis_index`` gives inside JAX's mesh
program). Ranks are laid out as JAX's flat fallback lays out devices,
``np.reshape(ranks, (dp, pp, sp, tp))``, so rank r's coordinates are JAX
device r's.

JAX's collectives run inside a mesh program, where the axis names are
bound. The port's run on the current mesh: :func:`build_mesh` installs
the mesh it builds, and ``with mesh:`` installs another for a block.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Canonical axis names, outermost → innermost.
DP_AXIS = "dp"
PP_AXIS = "pp"
SP_AXIS = "sp"
TP_AXIS = "tp"
AXIS_ORDER: Tuple[str, ...] = (DP_AXIS, PP_AXIS, SP_AXIS, TP_AXIS)

_DEFAULT: List[Optional["Mesh"]] = [None]
_STACK: List["Mesh"] = []


class Mesh:
    """Named axes over a ``DeviceMesh``: ``shape`` maps each axis name to
    its size (JAX's ``mesh.shape``), ``devices`` holds the ranks in the
    mesh's layout (JAX's ``mesh.devices``); :meth:`group`, :meth:`size`
    and :meth:`index` resolve an axis for this rank."""

    def __init__(self, device_mesh, axis_names: Sequence[str] = AXIS_ORDER):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.devices = np.asarray(device_mesh.mesh.cpu())
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self.device_type = device_mesh.device_type
        self._coord = tuple(device_mesh.get_coordinate())

    def _check(self, axis: str) -> None:
        if axis not in self.shape:
            raise NameError(f"unbound axis name: {axis!r} (mesh axes "
                            f"{self.axis_names})")

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        self._check(axis)
        return self.device_mesh.get_group(axis)

    def size(self, axis: str) -> int:
        self._check(axis)
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        self._check(axis)
        return self._coord[self.axis_names.index(axis)]

    def coordinates(self) -> Tuple[int, ...]:
        """This rank's coordinates, one an axis in ``axis_names`` order."""
        return self._coord

    def __enter__(self) -> "Mesh":
        _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _STACK.pop()

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device_type})"


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Install ``mesh`` as the current mesh outside any ``with`` block
    (``None`` uninstalls it)."""
    _DEFAULT[0] = mesh


def get_mesh(required: bool = True) -> Optional[Mesh]:
    """The current mesh: the innermost ``with mesh:``, else the one
    :func:`build_mesh` installed. Raises when none is, unless
    ``required=False``."""
    mesh = _STACK[-1] if _STACK else _DEFAULT[0]
    if mesh is None and required:
        raise RuntimeError(
            "no mesh is installed: call initialize_distributed() "
            "(parallel.multiproc) and build_mesh() first — a named axis "
            "is bound only on a mesh, as in JAX's mesh program")
    return mesh


def axis_size(axis_name, mesh: Optional[Mesh] = None) -> int:
    """Size of a mesh axis: ``axis_size(name)`` on the current mesh,
    ``axis_size(name, mesh)`` or, JAX's legacy order, ``axis_size(mesh,
    name)``."""
    if isinstance(axis_name, Mesh):
        return axis_name.shape[mesh]
    if mesh is not None:
        return mesh.shape[axis_name]
    return get_mesh().size(axis_name)


def mesh_shape(n: int, tp: int = 1, pp: int = 1, sp: int = 1,
               dp: int = -1) -> Tuple[int, int, int, int]:
    """``(dp, pp, sp, tp)`` for ``n`` devices, with JAX's divisibility
    errors (``dp=-1``: all remaining devices)."""
    model = tp * pp * sp
    if dp == -1:
        if n % model != 0:
            raise ValueError(
                f"device count {n} is not divisible by tp*pp*sp = {model}")
        dp = n // model
    if dp * model != n:
        raise ValueError(
            f"mesh shape dp={dp} pp={pp} sp={sp} tp={tp} requires "
            f"{dp * model} devices, have {n}")
    return (dp, pp, sp, tp)


def _world() -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs torch.distributed initialized: call "
            "parallel.multiproc.initialize_distributed() (or run under "
            "parallel.multiproc.spawn)")
    return dist.get_world_size()


def _device_type() -> str:
    backend = dist.get_backend()
    return "cuda" if "nccl" in str(backend) else "cpu"


def build_mesh(tp: int = 1, pp: int = 1, sp: int = 1, dp: int = -1,
               devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build the 4-axis mesh over the default process group's ranks (or
    over ``devices``, ranks in the order to lay out) and make it the
    current mesh. ``dp=-1`` means every remaining rank; the errors are
    JAX's."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    world = _world()
    n = world if devices is None else len(devices)
    shape = mesh_shape(n, tp=tp, pp=pp, sp=sp, dp=dp)
    if devices is None:
        dm = init_device_mesh(_device_type(), shape,
                              mesh_dim_names=AXIS_ORDER)
    else:
        ranks = torch.tensor(list(devices), dtype=torch.int64)
        dm = DeviceMesh(_device_type(), ranks.reshape(shape),
                        mesh_dim_names=AXIS_ORDER)
    mesh = Mesh(dm)
    set_mesh(mesh)
    return mesh


def build_hybrid_mesh(tp: int = 1, pp: int = 1, sp: int = 1,
                      dp_per_slice: int = -1,
                      devices: Optional[Sequence[int]] = None,
                      num_slices: int = 1) -> Mesh:
    """JAX's DCN × ICI mesh, read for hosts: ``num_slices`` groups of
    consecutive ranks (one a host, ranks host-major), data parallelism
    the only axis that crosses them. One slice is :func:`build_mesh`. With
    several, each slice holds ``dp_per_slice · tp · pp · sp`` ranks and dp
    runs slice-major, as ``create_hybrid_device_mesh`` concatenates the
    slices' meshes along dp."""
    if num_slices <= 1:
        return build_mesh(tp=tp, pp=pp, sp=sp, dp=dp_per_slice,
                          devices=devices)
    n = _world() if devices is None else len(devices)
    per_slice = n // num_slices
    model = tp * pp * sp
    if dp_per_slice == -1:
        if per_slice % model:
            raise ValueError(
                f"devices per slice ({per_slice}) not divisible by "
                f"tp*pp*sp = {model}")
        dp_per_slice = per_slice // model
    if dp_per_slice * model != per_slice:
        raise ValueError(
            f"dp_per_slice={dp_per_slice} x tp*pp*sp={model} != devices "
            f"per slice ({per_slice})")
    return build_mesh(tp=tp, pp=pp, sp=sp, dp=dp_per_slice * num_slices,
                      devices=devices)


def model_parallel_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Every axis but data parallel (the "model-parallel group")."""
    return tuple(a for a in mesh.axis_names if a != DP_AXIS)


def resolve_axis(axis, mesh: Optional[Mesh] = None):
    """``(group, size, index)`` of an axis: a name on ``mesh`` (the
    current mesh by default), or a ``torch.distributed`` process group
    itself."""
    if isinstance(axis, str):
        m = get_mesh() if mesh is None else mesh
        return m.group(axis), m.size(axis), m.index(axis)
    return axis, dist.get_world_size(axis), dist.get_rank(axis)
