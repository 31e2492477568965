"""Named-span tracing (counterpart of ``apex_tpu/monitor/trace.py``).

One :func:`span` plants both markers a CUDA profile joins with kernel
launches:

* ``torch.profiler.record_function`` — a range in the torch profiler's
  trace (``key_averages()`` rows and the Chrome trace it exports), where
  JAX plants ``jax.named_scope`` + ``TraceAnnotation``;
* ``torch.cuda.nvtx`` — an NVTX range for Nsight, pushed only when CUDA is
  initialised in this process (a CPU-only run never initialises it for a
  marker).

Canonical phase names are :data:`PHASES`, JAX's; the serving engine traces
its calls under ``"prefill"``, ``"decode"`` and ``"verify"``.
:func:`step_annotation` marks one step the same way, named
``"<name>#<step>"`` as the torch profiler names its own step ranges.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterator, Optional

import torch

# JAX's canonical phases, plus "verify", the engine's speculative call
# (JAX traces it under "decode")
PHASES = ("fwd", "bwd", "comm", "opt", "ckpt", "prefill", "decode",
          "verify", "transfer", "scrape")


def _nvtx_on() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Named range in the torch profiler and, with CUDA initialised, in
    NVTX. Nesting composes as the profilers nest ranges. The profiler
    range is opened only while a torch profiler records (outside one it
    would cost a dispatcher call a span and record nothing)."""
    rf = torch.profiler.record_function(name) if _profiling() else None
    nvtx = _nvtx_on()
    if rf is not None:
        rf.__enter__()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        if rf is not None:
            rf.__exit__(None, None, None)


def span_function(fn: Callable = None, *, name: Optional[str] = None):
    """Decorator form of :func:`span`: the function body runs under
    ``name`` (default: its qualname)."""
    if fn is None:
        return functools.partial(span_function, name=name)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with span(name or fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapped


def step_annotation(step: int, name: str = "train_step"):
    """Step marker around one step's call::

        with monitor.step_annotation(i):
            loss = train_step()
    """
    return span(f"{name}#{int(step)}")
