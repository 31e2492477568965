"""Process bootstrap (counterpart of ``apex_tpu/parallel/multiproc.py``).

* :func:`initialize_distributed` — ``torch.distributed.init_process_group``
  from ``RANK`` / ``WORLD_SIZE`` and a rendezvous (``init_method=``, or
  ``MASTER_ADDR`` / ``MASTER_PORT``; with neither, one process makes a
  one-rank group at a free localhost port). NCCL on the card, ``gloo``
  for CPU tensors (``device="cpu"``).
* :func:`spawn` — run ``fn(rank, world, *args)`` in ``world`` fresh
  processes over one process group and return each rank's result in
  rank order. A child imports torch, this package and ``fn``'s module,
  nothing else.
* ``python -m apex_tpu_torch.parallel.multiproc N -- cmd ...`` — run
  ``cmd`` N times with ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` and a
  shared ``MASTER_ADDR`` / ``MASTER_PORT`` in the environment.
"""

from __future__ import annotations

import io
import os
import pickle
import queue as queue_mod
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch._device import DeviceLike, resolve_device


def free_port() -> int:
    """A TCP port on localhost that is free right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_int(*names) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return int(v)
    return None


def initialize_distributed(device: DeviceLike = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> Tuple[int, int]:
    """Initialize the default process group; returns ``(rank, world)``.
    ``world_size`` / ``rank`` fall back to ``WORLD_SIZE`` / ``RANK``
    (then 1 / 0); the rendezvous to ``init_method``, then ``env://`` when
    ``MASTER_ADDR`` is set, then (one process only) a free localhost
    port. The backend is NCCL for the card (``device`` defaults to
    ``cuda``, which then becomes this process's device) and ``gloo`` for
    ``device="cpu"``. A group already initialized is kept."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = resolve_device(device)
    if world_size is None:
        world_size = _env_int("WORLD_SIZE", "NPROCS") or 1
    if rank is None:
        rank = _env_int("RANK", "PROCESS_ID") or 0
    if init_method is None:
        if os.environ.get("MASTER_ADDR"):
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://127.0.0.1:{free_port()}"
        else:
            raise ValueError(
                "initialize_distributed: world size "
                f"{world_size} needs a rendezvous: init_method= or "
                "MASTER_ADDR / MASTER_PORT")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return rank, world_size


def destroy_distributed() -> None:
    """Tear down the default process group and uninstall the mesh."""
    from apex_tpu_torch.parallel.mesh import set_mesh

    set_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_host(v) for v in x)
    return x


def _pack(result) -> bytes:
    """A result as bytes (``torch.save``): tensors travel by value, not as
    shared memory that would need the rank alive to be read."""
    buf = io.BytesIO()
    torch.save(_to_host(result), buf)
    return buf.getvalue()


def _child(rank: int, world: int, init_method: str, call_path: str,
           out) -> None:
    # the ranks share the host's cores: a rank's intra-op pool its share
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        initialize_distributed(device="cpu", init_method=init_method,
                               world_size=world, rank=rank)
        try:
            result = fn(rank, world, *args)
        finally:
            destroy_distributed()
        out.put((rank, True, _pack(result)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


SPAWN_TIMEOUT_S = 300.0


def spawn(fn: Callable[..., Any], world: int, *args: Any) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each
    a rank of one ``gloo`` group (rendezvous through a ``file://`` store
    in a fresh temporary directory); return the results in rank order,
    tensors moved to host copies. ``fn`` must be importable by name (a
    module-level function). A rank that raises, dies or outlives
    ``SPAWN_TIMEOUT_S`` fails the call with its traceback; every child is
    stopped before this returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="apex_spawn_") as tmp:
        method = f"file://{os.path.join(tmp, 'store')}"
        # the call goes by file: a start's pipe blocks the parent until
        # the child has imported torch once it holds more than a pipe's
        # buffer, which would start the ranks one after another
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_child,
                             args=(r, world, method, call_path, out),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        results: dict = {}
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        done = False
        try:
            while len(results) < world:
                try:
                    rank, ok, val = out.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and not p.is_alive()
                            and p.exitcode not in (0, None)]
                    if dead:
                        raise RuntimeError(
                            f"spawn: rank(s) {dead} died (exit codes "
                            f"{[procs[r].exitcode for r in dead]})")
                    if time.monotonic() > deadline:
                        left = sorted(set(range(world)) - set(results))
                        raise TimeoutError(f"spawn: ranks {left} did not "
                                           f"finish in {SPAWN_TIMEOUT_S:g} s")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} raised:\n{val}")
                results[rank] = torch.load(io.BytesIO(val),
                                           weights_only=False)
            done = True
        finally:
            # a failed call stops every rank at once: the others may wait
            # in a collective for the one that failed
            for p in procs:
                p.join(timeout=10 if done else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(world)]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3 or argv[1] != "--":
        print("usage: python -m apex_tpu_torch.parallel.multiproc N -- cmd "
              "[args...]", file=sys.stderr)
        return 2
    world = int(argv[0])
    cmd = argv[2:]
    base = dict(os.environ)
    base.setdefault("MASTER_ADDR", "127.0.0.1")
    base.setdefault("MASTER_PORT", str(free_port()))
    procs = []
    for rank in range(world):
        env = dict(base, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        procs.append(subprocess.Popen(cmd, env=env))
    rc = 0
    for p in procs:
        rc = rc or p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
