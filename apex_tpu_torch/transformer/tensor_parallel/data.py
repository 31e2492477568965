"""Input-data broadcast across the tensor-parallel group (counterpart of
``apex_tpu/transformer/tensor_parallel/data.py``).

Only the group's first rank reads the batch; :func:`broadcast_data` checks
the members' dtypes, flattens them into one buffer, broadcasts it from
that rank over the tp group and unpacks it. JAX runs one program that sees
the same inputs everywhere and broadcasts only across hosts; the port's
ranks are processes, so this is the reference's broadcast. The shapes are
the same on every rank by contract (the reference ships them first).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel.mesh import TP_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import axis_info


def _check_data_types(keys: Sequence[str], data: Dict[str, torch.Tensor],
                      dtype) -> None:
    for k in keys:
        if data[k].dtype != dtype:
            raise TypeError(f"{k} has data type {data[k].dtype} which is "
                            f"different than {dtype}")


def _build_key_size_numel_dictionaries(keys, data):
    key_size = {k: tuple(data[k].shape) for k in keys}
    key_numel = {k: int(data[k].numel()) for k in keys}
    return key_size, key_numel, sum(key_numel.values())


def broadcast_data(keys, data, datatype=torch.int64,
                   axis_name: str = TP_AXIS):
    """The members ``keys`` of ``data`` as the group's first rank holds
    them, on every rank of the ``axis_name`` group."""
    key_size, key_numel, _ = _build_key_size_numel_dictionaries(keys,
                                                                    data)
    _check_data_types(keys, data, datatype)
    group, world, _ = axis_info(axis_name)
    if world == 1:
        return {k: data[k] for k in keys}
    flat = torch.cat([data[k].reshape(-1) for k in keys]).contiguous()
    dist.broadcast(flat, dist.get_global_rank(group, 0), group=group)
    out, offset = {}, 0
    for k in keys:
        out[k] = flat[offset:offset + key_numel[k]].view(key_size[k])
        offset += key_numel[k]
    return out
