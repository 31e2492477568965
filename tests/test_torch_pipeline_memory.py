"""The memory / recompute trade of the port's pipeline schedules: the
port's form of ``tests/test_pipeline_memory.py``'s two properties
(without ``benchmarks/``: measured with
``torch.autograd.graph.saved_tensors_hooks``).

A toy stage of two residual MLP sublayers (HID 16 → 64 → 16, so a
stage's interior saves 5 boundary-sized tensors a sublayer) runs through
the 1F1B driver with no mesh (one stage) at a fixed microbatch of 2 rows
× 8 tokens. The bytes of the distinct storages autograd saves in the
forward are counted at M 4 and M 8:

* with ``remat=True`` they grow per microbatch by boundary tensors only:
  at most 4 (the embedding's input, the stage input the checkpoint keeps,
  the stage output the head reads, the loss's residual), where a stage
  that kept its interior adds 9 more (each sublayer's 4-wide activation,
  and the second sublayer's input);
* ``remat=True`` saves less than ``remat=False``.

JAX's third property (the recompute factor from XLA's cost model) has no
counterpart here: the port's recompute is the checkpoint's, one stage
forward a tick.
"""

import contextlib

import torch

HID, WIDE, ROWS, SEQ, SUBLAYERS = 16, 64, 2, 8, 2
BOUNDARY = ROWS * SEQ * HID * 4


def _spec():
    from apex_tpu_torch.transformer.pipeline_parallel import PipelineSpec

    def stage_fn(sp, h):
        for i in range(SUBLAYERS):
            h = h + torch.tanh(h @ sp["w1"][i]) @ sp["w2"][i]
        return h

    return PipelineSpec(lambda ep, x: x @ ep["w"], stage_fn,
                        lambda hp, h, t: ((h @ hp["w"] - t) ** 2).mean())


def _params():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.2

    return {"embed": {"w": r(HID, HID)},
            "stages": {"w1": r(SUBLAYERS, HID, WIDE),
                       "w2": r(SUBLAYERS, WIDE, HID)},
            "head": {"w": r(HID, HID)}}


@contextlib.contextmanager
def _saved_bytes(out):
    """Sum into ``out[0]`` the bytes of every distinct storage autograd
    saves while open."""
    seen = set()

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() not in seen:
            seen.add(s.data_ptr())
            out[0] += s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        yield


def _measure(M, remat):
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_without_interleaving as drive,
    )

    g = torch.Generator().manual_seed(1)
    x = torch.randn(M * ROWS, SEQ, HID, generator=g)
    t = torch.randn(M * ROWS, SEQ, HID, generator=g)
    out = [0]
    with _saved_bytes(out):
        loss, _ = drive(_spec(), _params(), (x, t), num_microbatches=M,
                        remat=remat)
    assert torch.isfinite(loss)
    return out[0]


def test_remat_growth_in_m_is_boundary_tensors_only():
    slope = (_measure(8, True) - _measure(4, True)) / 4
    slope_no_remat = (_measure(8, False) - _measure(4, False)) / 4
    assert 0 < slope <= 4 * BOUNDARY, (slope, BOUNDARY)
    # the interior the checkpoint does not keep: 5 boundaries a sublayer,
    # but for the stage input, which it keeps
    assert slope_no_remat - slope >= (5 * SUBLAYERS - 1) * BOUNDARY, (
        slope_no_remat, slope, BOUNDARY)


def test_remat_saves_less_than_no_remat():
    for M in (4, 8):
        assert _measure(M, True) < _measure(M, False)
