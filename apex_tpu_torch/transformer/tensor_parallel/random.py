"""RNG policy and activation checkpointing (counterpart of
``apex_tpu/transformer/tensor_parallel/random.py``).

Keys are JAX's: a threefry key is a ``uint32[2]`` value, and every key the
JAX package derives (``fold_in``, ``split``, the per-layer and per-site
dropout streams) is a pure function of it. The port keeps them as numpy
arrays on the host and runs JAX's threefry-2x32 with
``jax_threefry_partitionable`` on (JAX 0.9's default) bit for bit:

* ``threefry2x32(k, (x0, x1))``: 20 rounds over the key schedule (k0, k1,
  k0 ^ k1 ^ 0x1BD11BDA), JAX's ``_threefry2x32_lowering``;
* ``fold_in(k, d) = threefry2x32(k, (0, d))`` (``_threefry_fold_in``);
* ``split(k, n)[i] = threefry2x32(k, (0, i))`` (``_threefry_split_foldlike``);
* ``random_bits(k, shape)[j] = b0 ^ b1`` with ``(b0, b1) =
  threefry2x32(k, (j >> 32, j & 0xFFFFFFFF))`` over the flat index j
  (``_threefry_random_bits_partitionable`` over ``iota_2x32_shape``);
* ``uniform`` and ``bernoulli`` from those bits as ``jax.random``'s fp32
  ``_uniform`` and ``_bernoulli`` (mode "low").

One definition of the rounds serves Python ints (a fold, a split, a
seed: a few microseconds each), numpy uint64 arrays (bits over a shape on
the host) and torch int64 tensors (:func:`random_bits_tensor`, the plain
version of the dropout kernel's draw, ``ops/dropout.py``), every value
held below 2**32 by masking. Nothing here reads the device, so a training
step that derives its keys here never syncs.

The tracker and seeds follow JAX's module: :class:`RngStatesTracker`'s
named streams, ``model_parallel_seed`` (the 2718 offset) and the per-rank
folds, with the tensor-parallel rank 0 until the port has a tensor-parallel
group (``rank=``). ``pipeline_stage_key`` waits for pipelining (A7d).

Checkpointing maps ``jax.checkpoint`` and its save policies onto
``torch.utils.checkpoint``: "nothing" recomputes everything, "dots" saves
the outputs of the products with no batch dimension (JAX's
``dots_with_no_batch_dims_saveable``) that the region's code marks
(:func:`saved_product`; the GPT layer's qkv, out, fc1 and fc2), and
"everything" does not checkpoint. A mark records its output in the
forward and hands it back in the recompute (:func:`saved_output`), as
JAX's ``checkpoint_name`` tags residuals; flash attention marks (o, lse)
as ``"attn"`` for GPT's ``dots_attn``. Dropout replays bit for bit in a
recompute: its draws are a function of (key, index) alone.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, Iterable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

M32 = 0xFFFFFFFF

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"
# The reference's seed-offset convention: "2718 is just for fun and any
# POSITIVE value will work."
_MODEL_PARALLEL_SEED_OFFSET = 2718

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


# ---------------------------------------------------------------------------
# threefry-2x32, JAX's definition


def threefry2x32(key, x0, x1):
    """JAX's ``threefry2x32_p``: ``(x0, x1)`` -> the two hashed words, for
    Python ints, numpy uint64 arrays or torch int64 tensors holding uint32
    values (each sum masked back below 2**32, each rotation's shift fits
    in 63 bits): the key schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA), then the
    20 rounds and 5 key injections of JAX's unrolled
    ``_threefry2x32_lowering``."""
    k0, k1 = _key_ints(key)
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


# ---------------------------------------------------------------------------
# keys


def _key_ints(key):
    """The key's two words as Python ints."""
    if (isinstance(key, np.ndarray) and key.dtype == np.uint32
            and key.shape == (2,)):
        return int(key[0]), int(key[1])
    k = _key_words(key)
    return int(k[0]), int(k[1])


def _key_words(key) -> np.ndarray:
    k = np.asarray(key)
    if k.shape != (2,) or not (np.issubdtype(k.dtype, np.integer)):
        raise TypeError(f"a threefry key is a uint32[2] array, got "
                        f"{k.dtype} {k.shape}")
    return k.astype(np.uint32)


def _key(k0: int, k1: int) -> np.ndarray:
    return np.array([k0 & M32, k1 & M32], dtype=np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` with JAX's default
    32-bit integers: the seed as int64 (an ``OverflowError`` outside its
    range, as ``np.int64(seed)`` raises), then its low 32 bits as the second
    word and 0 as the first, so a negative or 64-bit seed wraps as it does
    in JAX."""
    s = int(np.int64(seed))
    return _key(0, s & M32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: threefry2x32(key, (0, data))."""
    return _key(*threefry2x32(key, 0, int(data) & M32))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` (partitionable): a (num, 2) uint32
    array, row i = threefry2x32(key, (0, i))."""
    return np.stack([_key(*threefry2x32(key, 0, i)) for i in range(num)])


def random_bits(key, shape=()) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``: b0 ^ b1 of threefry2x32 over
    the (high, low) words of each element's flat index."""
    shape = tuple(shape)
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    b0, b1 = threefry2x32(key, idx >> 32, idx & M32)
    return (b0 ^ b1).astype(np.uint32).reshape(shape)


def _uniform_from_bits(bits: np.ndarray) -> np.ndarray:
    one = np.array(1.0, np.float32).view(np.uint32)
    return np.maximum(np.float32(0.0),
                      ((bits >> np.uint32(9)) | one).view(np.float32)
                      - np.float32(1.0))


def uniform(key, shape=(), dtype=np.float32) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in [0, 1), fp32 (the only type
    ported): the top 23 bits as the mantissa of a float in [1, 2), minus
    one."""
    if np.dtype(dtype) != np.float32:
        raise ValueError(f"uniform is ported for float32 only, got {dtype}")
    return _uniform_from_bits(random_bits(key, shape))


def bernoulli(key, p: float = 0.5, shape=()) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float p (JAX's
    fp32): ``uniform < float32(p)``."""
    return uniform(key, shape) < np.float32(p)


def keep_threshold(p: float) -> int:
    """The integer T with ``uniform < float32(p)`` exactly when ``bits >> 9
    < T``: uniform is (bits >> 9)·2**-23 exactly, so T = ceil(float32(p) ·
    2**23), which the dropout kernel compares against."""
    p32 = float(np.float32(p))
    return int(np.ceil(np.float64(p32) * 2.0 ** 23))


def random_bits_tensor(key, numel: int, device=None) -> torch.Tensor:
    """``random_bits(key, (numel,))`` as an int64 tensor of uint32 values on
    ``device``, computed there with torch ops: the plain version of the
    dropout kernel's per-element draw."""
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & M32)
    return b0 ^ b1


# ---------------------------------------------------------------------------
# seeds and streams (tensor-parallel rank 0 until A7c brings a group)


def model_parallel_key(key, rank: int = 0) -> np.ndarray:
    """A key distinct per tensor-parallel rank, the same across data-
    parallel replicas: ``fold_in(fold_in(key, 2718), rank)`` (JAX folds
    ``lax.axis_index(tp)``)."""
    return fold_in(fold_in(key, _MODEL_PARALLEL_SEED_OFFSET), rank)


def data_parallel_key(key) -> np.ndarray:
    """The default stream, the same across the tensor-parallel group: the
    key itself."""
    return _key_words(key)


def attention_dropout_seed(key, rank: int = 0) -> int:
    """The int32 seed of the flash kernels' attention dropout:
    ``bits(model_parallel_key(key, rank))`` as a signed 32-bit int, JAX's
    ``jax.random.bits(..., uint32).astype(int32)``."""
    b0, b1 = threefry2x32(model_parallel_key(key, rank), 0, 0)
    b = b0 ^ b1
    return b - (1 << 32) if b >= 1 << 31 else b


class RngStatesTracker:
    """Named key streams with the reference tracker's API: each stream holds
    a base key and a counter, and :meth:`key` hands out ``fold_in(base,
    counter)`` and advances the counter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._keys: Dict[str, np.ndarray] = {}
        self._counters: Dict[str, int] = {}
        self._seeds = set()

    def get_states(self):
        """``{name: (key, counter)}``; restoring it replays the same keys."""
        return {name: (key, self._counters[name])
                for name, key in self._keys.items()}

    def set_states(self, states):
        self._keys, self._counters = {}, {}
        for name, entry in states.items():
            key, counter = entry if isinstance(entry, tuple) else (entry, 0)
            self._keys[name] = _key_words(key)
            self._counters[name] = counter

    def add(self, name: str, seed_or_key):
        if name in self._keys:
            raise RuntimeError(f"rng state {name!r} already exists")
        if isinstance(seed_or_key, int):
            if seed_or_key in self._seeds:
                raise RuntimeError(f"seed {seed_or_key} already exists")
            self._seeds.add(seed_or_key)
            key = prng_key(seed_or_key)
        else:
            key = _key_words(seed_or_key)
        self._keys[name] = key
        self._counters[name] = 0

    def key(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME):
        """The next key of the named stream."""
        if name not in self._keys:
            raise RuntimeError(f"rng state {name!r} is not added")
        k = fold_in(self._keys[name], self._counters[name])
        self._counters[name] += 1
        return k

    @contextlib.contextmanager
    def fork(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME):
        """Yields the stream's next key (the reference swaps device RNG
        state here; a key is handed to the caller instead)."""
        yield self.key(name)


_RNG_STATE_TRACKER = RngStatesTracker()


def get_rng_tracker() -> RngStatesTracker:
    return _RNG_STATE_TRACKER


get_cuda_rng_tracker = get_rng_tracker


def model_parallel_seed(seed: int):
    """Installs the "default" stream (``prng_key(seed)``) and the model-
    parallel stream (its fold with 2718) on the tracker; returns its
    states. The rank fold is left to the caller, as in JAX."""
    tracker = get_rng_tracker()
    tracker.reset()
    base = prng_key(seed)
    tracker.add("default", base)
    tracker.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                fold_in(base, _MODEL_PARALLEL_SEED_OFFSET))
    return tracker.get_states()


model_parallel_cuda_manual_seed = model_parallel_seed


# ---------------------------------------------------------------------------
# activation checkpointing


class _SavedOutputs:
    """The outputs one checkpointed call saves: each value its code passes
    through :func:`saved_output` under one of ``kinds``, recorded
    (detached) in the forward and handed back, in the same order, in the
    recompute."""

    def __init__(self, kinds):
        self.kinds = frozenset(kinds)
        self.values = []
        self.replaying = False
        self.pos = 0

    def phase(self, replaying: bool):
        return _TapePhase(self, replaying)

    def next(self):
        value = self.values[self.pos]
        self.pos += 1
        return value


class _TapePhase:
    """Makes ``tape`` the current thread's tape while the forward (record)
    or a recompute (replay) runs; reusable, as a recompute may run again
    for a second backward."""

    def __init__(self, tape: _SavedOutputs, replaying: bool):
        self.tape, self.replaying, self.prev = tape, replaying, None

    def __enter__(self):
        self.prev = getattr(_ACTIVE, "tape", None)
        self.tape.replaying, self.tape.pos = self.replaying, 0
        _ACTIVE.tape = self.tape

    def __exit__(self, *exc):
        _ACTIVE.tape = self.prev


# the tape of the checkpointed call running on this thread (a recompute runs
# on the autograd engine's thread)
_ACTIVE = threading.local()


def saved_output(kind: str, compute: Callable, replay: Callable = None):
    """``compute()``, saved when the checkpointed call running on this
    thread saves ``kind``: its outputs recorded (detached) in the forward;
    in the recompute, ``replay(saved)`` (the saved value itself when None)
    in place of ``compute()``. Outside such a call, ``compute()``."""
    tape = getattr(_ACTIVE, "tape", None)
    if tape is None or kind not in tape.kinds:
        return compute()
    if tape.replaying:
        saved = tape.next()
        return saved if replay is None else replay(saved)
    out = compute()
    tape.values.append(tuple(t.detach() for t in out)
                       if isinstance(out, tuple) else out.detach())
    return out


class _ReturnFor(TorchDispatchMode):
    """Hands back ``value`` (viewed to the op's output shape) for every call
    of ``op`` and runs every other op: the op's autograd node is still
    made, saving what it saves, but its kernel does not run."""

    def __init__(self, op, value):
        super().__init__()
        self.op, self.value = op, value

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is self.op:
            return self.value.view(args[0].shape[0], args[1].shape[1])
        return func(*args, **(kwargs or {}))


def saved_product(x, kernel):
    """``torch.matmul(x, kernel)`` of (rows, k) @ (k, n) rows (x with
    leading dims), saved under the ``"dots"`` kind: JAX's
    ``dots_with_no_batch_dims_saveable`` names exactly these products. In
    the recompute the product's autograd node is rebuilt around the saved
    output, so backward reads the same tensors and the GEMM does not run
    again."""
    def replay(saved):
        with _ReturnFor(torch.ops.aten.mm.default, saved):
            return torch.matmul(x, kernel)

    return saved_output("dots", lambda: torch.matmul(x, kernel), replay)


#: policy -> the kinds of output a checkpointed region saves ("dots": the
#: products marked by :func:`saved_product`); "everything" does not
#: checkpoint
CHECKPOINT_POLICIES = {
    "nothing": (),
    "dots": ("dots",),
    "everything": None,
}


class _both:
    """The save tape's phase (when there is a tape) and, in the recompute,
    amp's autocast mode that was active in the forward (when one was), so
    the recomputed layer runs under the forward's casts. Reusable, as a
    recompute may run again."""

    def __init__(self, tape, recompute: bool, mode):
        self.tape, self.recompute, self.mode = tape, recompute, mode
        self.stacks = []

    def __enter__(self):
        stack = contextlib.ExitStack()
        if self.tape is not None:
            stack.enter_context(self.tape.phase(self.recompute))
        if self.mode is not None:
            stack.enter_context(self.mode)
        self.stacks.append(stack)
        return self

    def __exit__(self, *exc):
        return self.stacks.pop().__exit__(*exc)


def checkpoint_saving(function: Callable, kinds: Iterable[str] = ()
                      ) -> Callable:
    """``function`` recomputed in backward (``torch.utils.checkpoint``,
    non-reentrant), saving the outputs its code marks with
    :func:`saved_output` under ``kinds`` (nothing when empty). The marks
    cost a list append in the forward and a lookup in the recompute, where
    a selective-checkpoint dispatch mode would run Python for every op of
    the region."""
    from torch.utils.checkpoint import checkpoint as _checkpoint

    kinds = tuple(kinds)

    @functools.wraps(function)
    def run(*args, **kwargs):
        from apex_tpu_torch.amp.autocast import active_mode

        kw = {}
        mode = active_mode()
        if kinds or mode is not None:
            tape = _SavedOutputs(kinds) if kinds else None
            kw["context_fn"] = lambda: (_both(tape, False, None),
                                        _both(tape, True, mode))
        return _checkpoint(function, *args, use_reentrant=False, **kw,
                           **kwargs)

    return run


def checkpoint_wrapper(function: Callable, policy: str = "nothing"
                       ) -> Callable:
    """``function`` under the named policy of :data:`CHECKPOINT_POLICIES`.
    A function whose products go through :func:`saved_product` (the port's
    GPT layer does) saves them under "dots"; other products are
    recomputed."""
    if policy not in CHECKPOINT_POLICIES:
        raise ValueError(
            f"policy must be one of {sorted(CHECKPOINT_POLICIES)}")
    kinds = CHECKPOINT_POLICIES[policy]
    if kinds is None:
        return function
    return checkpoint_saving(function, kinds)


def checkpoint(function: Callable, *args, policy: str = "nothing",
               **kwargs):
    """Run ``function(*args, **kwargs)`` checkpointed: intermediates are
    recomputed in backward (those the policy saves excepted). A dropout key
    is an argument, so the recompute draws the same masks."""
    return checkpoint_wrapper(function, policy=policy)(*args, **kwargs)
