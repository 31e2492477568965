"""Named fp32 scalars of one step (counterpart of
``apex_tpu/monitor/metrics.py``).

:class:`Metrics` is an immutable mapping from metric name to an fp32 scalar
tensor, names kept sorted, with JAX's methods (``record``, ``accumulate``,
``merge``, ``as_dict`` ...). A value may live on the card — a
:func:`global_norm` of gradients stays there until :meth:`Metrics.as_dict`
reads every value back in one transfer — or on the host: the serving
engine records its per-step ``active_slots`` / ``context_tokens`` from the
host copies of its slot state, so recording them adds no device read to
the step (JAX computes the same two sums inside its decode program).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch


def _scalar(v) -> torch.Tensor:
    """A metric value as an fp32 0-d tensor (bools become 0.0 / 1.0). A
    tensor keeps its device; a Python number becomes a CPU tensor."""
    if isinstance(v, torch.Tensor):
        if v.dim() != 0:
            raise ValueError(
                f"metrics are scalars; got shape {tuple(v.shape)} — reduce "
                f"first (e.g. global_norm)")
        return v.detach().to(torch.float32)
    t = torch.tensor(v, dtype=torch.float32)
    if t.dim() != 0:
        raise ValueError(f"metrics are scalars; got shape {tuple(t.shape)} "
                         f"— reduce first (e.g. global_norm)")
    return t


class Metrics:
    """Immutable named-scalar mapping; every update returns a new
    Metrics."""

    __slots__ = ("_values",)

    def __init__(self, values: Optional[Mapping[str, Any]] = None):
        vals = {k: _scalar(v) for k, v in dict(values or {}).items()}
        object.__setattr__(self, "_values", dict(sorted(vals.items())))

    def __setattr__(self, name, value):
        raise AttributeError("Metrics is immutable: use record/accumulate")

    # -- functional updates ------------------------------------------------
    def record(self, **entries) -> "Metrics":
        """New Metrics with ``entries`` added (overwriting same names)."""
        merged = dict(self._values)
        merged.update(entries)
        return Metrics(merged)

    def accumulate(self, **entries) -> "Metrics":
        """New Metrics with ``entries`` added to the existing values
        (counters); missing names start at 0."""
        merged = dict(self._values)
        for k, v in entries.items():
            s = _scalar(v)
            prev = merged.get(k)
            merged[k] = s if prev is None else prev.to(s.device) + s
        return Metrics(merged)

    def merge(self, other: "Metrics") -> "Metrics":
        """New Metrics with ``other``'s entries (other wins on collision)."""
        merged = dict(self._values)
        merged.update(other._values)
        return Metrics(merged)

    # -- access ------------------------------------------------------------
    def __getitem__(self, name: str) -> torch.Tensor:
        return self._values[name]

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def __iter__(self) -> Iterator[str]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def names(self) -> Tuple[str, ...]:
        return tuple(self._values.keys())

    def as_dict(self) -> Dict[str, float]:
        """Host readout: the values on a device come back in one transfer
        (one stacked copy per device), the host ones are read as they
        are."""
        out: Dict[str, float] = {}
        by_dev: Dict[torch.device, list] = {}
        for k, v in self._values.items():
            if v.device.type == "cpu":
                out[k] = float(v)
            else:
                by_dev.setdefault(v.device, []).append(k)
        for dev, keys in by_dev.items():
            host = torch.stack([self._values[k] for k in keys]).cpu()
            out.update({k: float(x) for k, x in zip(keys, host)})
        return {k: out[k] for k in self._values}

    def __repr__(self):
        return f"Metrics({list(self._values.keys())})"


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def global_norm(tree) -> torch.Tensor:
    """Global L2 norm over every tensor of a (nested dict / list) tree, in
    fp32, on the tensors' device; 0.0 for an empty tree."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.tensor(0.0, dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(g.detach().float()))
                          for g in leaves))


def train_metrics(metrics: Optional[Metrics] = None, *, loss=None,
                  grads=None, params=None, updates=None) -> Metrics:
    """Record the standard per-step scalars: ``loss`` plus the global norms
    of whatever trees are given (``grad_norm``, ``param_norm``,
    ``update_norm``)."""
    m = metrics if metrics is not None else Metrics()
    entries: Dict[str, Any] = {}
    if loss is not None:
        entries["loss"] = loss
    if grads is not None:
        entries["grad_norm"] = global_norm(grads)
    if params is not None:
        entries["param_norm"] = global_norm(params)
    if updates is not None:
        entries["update_norm"] = global_norm(updates)
    return m.record(**entries)
