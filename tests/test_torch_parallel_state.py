"""The port's ``transformer.parallel_state`` against the JAX package's.

JAX builds its mesh over the conftest's 8 CPU devices; the port's over 8
``gloo`` ranks (one spawn for every grid). At (tp, pp, sp) in {(2,1,1),
(2,2,1), (2,1,2), (4,1,2)} the port's rank layout is JAX's device layout
(``mesh.devices`` equal), every rank's accessors return its coordinates
in that layout (JAX's ``lax.axis_index``, a Python int here), the world
sizes are JAX's, and the split and virtual-pipeline bookkeeping answers
as JAX's host-side predicates do. The errors are JAX's.
"""

import functools

import numpy as np
import pytest

from apex_tpu.transformer import parallel_state as jps
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.transformer import parallel_state as ps

import torch_tp_workers as workers

WORLD = 8
GRIDS = ((2, 1, 1), (2, 2, 1), (2, 1, 2), (4, 1, 2))


def _split(pp):
    return 1 if pp > 1 else None


@functools.lru_cache(maxsize=None)
def _spawned():
    calls = {f"grid{tp}{pp}{sp}": ("state_grid", (tp, pp, sp, _split(pp)))
             for tp, pp, sp in GRIDS}
    calls["bad"] = ("bad_grid", ())
    return spawn(workers.several, WORLD, calls)


def test_ranks_import_no_jax():
    assert not any(r["jax_loaded"] for r in _spawned())


@pytest.mark.parametrize("tp,pp,sp", GRIDS)
def test_grid_matches_jax(tp, pp, sp):
    jmesh = jps.initialize_model_parallel(tp, pp, 2 if pp > 1 else None, sp,
                                          _split(pp))
    try:
        jdev = np.vectorize(lambda d: d.id)(jmesh.devices)
        sizes = (jps.get_data_parallel_world_size(),
                 jps.get_pipeline_model_parallel_world_size(),
                 jps.get_sequence_parallel_world_size(),
                 jps.get_tensor_model_parallel_world_size(),
                 jps.get_model_parallel_world_size())
        axes = tuple(jps.get_model_parallel_axes())
        info = jps.get_rank_info()
        vpp = (jps.get_virtual_pipeline_model_parallel_world_size(),
               jps.get_virtual_pipeline_model_parallel_rank())
    finally:
        jps.destroy_model_parallel()
    for rank, res in enumerate(_spawned()):
        r = res[f"grid{tp}{pp}{sp}"]
        assert not r["before"]
        np.testing.assert_array_equal(r["devices"].numpy(), jdev)
        assert r["sizes"] == sizes
        assert tuple(r["axes"]) == axes
        assert r["info"] == info
        assert r["vpp"] == vpp
        coord = tuple(int(c) for c in np.argwhere(jdev == rank)[0])
        assert r["ranks"] == coord
        pp_rank = coord[1]
        first, last = pp_rank == 0, pp_rank == pp - 1
        # virtual rank 0 of 2 (pp > 1): last only on the last chunk
        assert r["first_last"] == (first, last and pp == 1, first, last)
        assert r["first_last_v1"] == (first and pp == 1, last)
        split = _split(pp)
        if split is None:
            assert r["split"] == (True, True, False)
        else:
            assert r["split"] == (pp_rank < split, pp_rank >= split,
                                  pp_rank < split <= pp_rank + 1)
        assert r["after"] == (False, "mesh uninitialized")


def test_errors_match_jax():
    """Non-dividing shapes (JAX's ``ValueError`` text), a split rank
    outside (0, pp), accessors before initialization."""
    jax_msgs = []
    for kw in (dict(tensor_model_parallel_size_=3),
               dict(pipeline_model_parallel_size_=2,
                    pipeline_model_parallel_split_rank_=2)):
        with pytest.raises(ValueError) as e:
            jps.initialize_model_parallel(**kw)
        jax_msgs.append(str(e.value))
    for r in _spawned():
        assert r["bad"] == jax_msgs
    ps.destroy_model_parallel()
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        ps.get_tensor_model_parallel_world_size()
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        ps.get_tensor_model_parallel_rank()
    assert ps.get_rank_info() == jps.get_rank_info() == "mesh uninitialized"
    assert (ps.get_tensor_model_parallel_axis(),
            ps.get_pipeline_model_parallel_axis(),
            ps.get_sequence_parallel_axis(),
            ps.get_data_parallel_axis()) == (
        jps.get_tensor_model_parallel_axis(),
        jps.get_pipeline_model_parallel_axis(),
        jps.get_sequence_parallel_axis(), jps.get_data_parallel_axis())
