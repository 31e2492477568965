"""Channel-permutation search for 2:4 structured sparsity (counterpart of
``apex_tpu/contrib/sparsity/permutation.py``; the port's own copy of that
host numpy code, which imports nothing of the JAX package).

Permuting the input channels of a weight matrix before m4n2 pruning
changes which elements fall into each group of four, so a good
permutation raises the magnitude the 2:4 mask preserves. The search is a
vectorized greedy descent: one numpy pass scores every candidate swap of
a column against all other columns, applied column by column until a
sweep finds no improvement, with bounded random-restart escapes drawn
from ``numpy.random.default_rng(seed)`` in JAX's order, so the search
returns JAX's permutation. It runs on the host: an offline preprocessing
pass over weights, not a device op.

This module finds and applies permutations on individual matrices;
propagating a permutation through a network (permuting the producing
layer's output channels to compensate) is model surgery the caller
drives.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from apex_tpu_torch.contrib.sparsity.sparse_masklib import create_mask

GROUP = 4  # m4n2: groups of 4 input channels, keep 2


def magnitude_after_2_4(matrix: np.ndarray) -> float:
    """Total |magnitude| preserved by 2:4 pruning along the last dim.

    ``matrix``: (rows, cols) with cols % 4 == 0. For every row and every
    aligned group of 4 columns, the 2 largest |values| survive.
    """
    a = np.abs(np.asarray(matrix, dtype=np.float32))
    r, c = a.shape
    g = a.reshape(r, c // GROUP, GROUP)
    # sum of top-2 per group = sum - (two smallest) = partition
    top2 = np.partition(g, GROUP - 2, axis=2)[:, :, GROUP - 2:]
    return float(top2.sum())


def _group_scores(a: np.ndarray) -> np.ndarray:
    """(rows, n_groups) preserved magnitude per aligned 4-column group."""
    r, c = a.shape
    g = a.reshape(r, c // GROUP, GROUP)
    return np.partition(g, GROUP - 2, axis=2)[:, :, GROUP - 2:].sum(axis=(0, 2))


_CHUNK_ELEMS = 16_000_000  # bound candidate temporaries to ~256 MB fp32


def _swap_gains(a: np.ndarray, col: int) -> np.ndarray:
    """Score improvement of swapping ``col`` with every other column.

    Returns (cols,) gains; entries inside ``col``'s own group are 0 (a swap
    within a group never changes the 2:4 score). Vectorized: builds the
    candidate group of ``col``'s group with each foreign column substituted
    in, and each foreign group with ``col`` substituted — chunked over
    candidate columns so temporaries stay bounded on large layers.
    """
    r, c = a.shape
    ngroups = c // GROUP
    gi = col // GROUP
    slot = col % GROUP
    groups = a.reshape(r, ngroups, GROUP)

    base = _group_scores(a)  # (ngroups,)
    gains = np.empty(c, np.float32)
    chunk = max(GROUP, min(c, _CHUNK_ELEMS // max(r * GROUP, 1)))
    slots = np.tile(np.arange(GROUP), ngroups)  # slot of each column j

    for j0 in range(0, c, chunk):
        j1 = min(j0 + chunk, c)
        n = j1 - j0
        # candidate A: col's group with column j substituted into col's slot
        cand_a = np.broadcast_to(groups[:, gi, None, :], (r, n, GROUP)).copy()
        cand_a[:, :, slot] = a[:, j0:j1]
        top2_a = np.partition(np.abs(cand_a), GROUP - 2, axis=2)[:, :, GROUP - 2:]
        score_a = top2_a.sum(axis=(0, 2))  # (n,)

        # candidate B: j's group with col substituted into j's slot
        cand_b = groups[:, j0 // GROUP:(j1 - 1) // GROUP + 1, :]
        cand_b = np.repeat(cand_b, GROUP, axis=1)[:, j0 % GROUP:, :][:, :n, :].copy()
        cand_b[:, np.arange(n), slots[j0:j1]] = a[:, [col]]
        top2_b = np.partition(np.abs(cand_b), GROUP - 2, axis=2)[:, :, GROUP - 2:]
        score_b = top2_b.sum(axis=(0, 2))  # (n,)

        gains[j0:j1] = (score_a + score_b) - (
            base[gi] + base[np.arange(j0, j1) // GROUP])
    gains[gi * GROUP:(gi + 1) * GROUP] = 0.0  # same-group swaps are no-ops
    return gains


def search_permutation(
    matrix: np.ndarray,
    escape_attempts: int = 10,
    max_sweeps: int = 100,
    seed: int = 0,
    max_rows: int = 4096,
) -> Tuple[np.ndarray, float, float]:
    """Greedy channel-permutation search maximizing post-2:4 magnitude.

    Returns ``(permutation, base_magnitude, best_magnitude)`` where
    ``matrix[:, permutation]`` is the permuted matrix achieving
    ``best_magnitude``. Greedy sweeps apply the best available swap per
    column until no swap improves; ``escape_attempts`` random swaps restart
    the descent from perturbed points (ref ``escape_attempts``), keeping the
    best permutation seen.

    Matrices with more than ``max_rows`` rows are row-subsampled for the
    *search* (the column grouping statistics concentrate well); the returned
    base/best magnitudes are always evaluated on the full matrix.
    """
    full = np.abs(np.asarray(matrix, dtype=np.float32))
    r, c = full.shape
    if c % GROUP != 0:
        raise ValueError(f"columns ({c}) must be divisible by {GROUP}")
    rng = np.random.default_rng(seed)
    a = full
    if r > max_rows:
        a = full[rng.choice(r, size=max_rows, replace=False)]
    perm = np.arange(c)
    base = magnitude_after_2_4(full)

    best_perm = perm.copy()
    best_score = base
    cur = a.copy()
    escapes_left = escape_attempts

    while True:
        improved = True
        sweeps = 0
        while improved and sweeps < max_sweeps:
            improved = False
            sweeps += 1
            for col in range(c):
                gains = _swap_gains(cur, col)
                j = int(np.argmax(gains))
                if gains[j] > 1e-6:
                    cur[:, [col, j]] = cur[:, [j, col]]
                    perm[[col, j]] = perm[[j, col]]
                    improved = True
        score = magnitude_after_2_4(full[:, perm])
        if score > best_score:
            best_score = score
            best_perm = perm.copy()
        if escapes_left <= 0:
            break
        # bounded escape: random swap pair, resume the descent
        escapes_left -= 1
        i, j = rng.choice(c, size=2, replace=False)
        cur[:, [i, j]] = cur[:, [j, i]]
        perm[[i, j]] = perm[[j, i]]

    return best_perm, base, best_score


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    """inv such that ``x[:, perm][:, inv] == x``."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def permute_and_mask(matrix, escape_attempts: int = 10, seed: int = 0):
    """Search a permutation, prune in the permuted domain, and return the
    mask mapped back to the ORIGINAL column order.

    This is the pure-masking use of the search (no model surgery): the mask
    computed on the permuted matrix is un-permuted, so callers keep their
    layout while the mask's group structure follows the permutation. Note
    the un-permuted mask is no longer aligned-4-group structured — hardware
    that requires aligned 2:4 groups needs the full weight-permutation
    surgery instead (see module docstring).

    ``matrix``: a numpy array or a tensor (read on the host). Returns
    ``(mask, perm, base_magnitude, best_magnitude)``, the mask a numpy
    bool array.
    """
    if torch.is_tensor(matrix):   # bf16 and fp16 widen exactly
        matrix = matrix.detach().float().cpu().numpy()
    m = np.asarray(matrix)
    orig_shape = m.shape
    m2 = m.reshape(-1, orig_shape[-1])
    perm, base, best = search_permutation(m2, escape_attempts, seed=seed)
    permuted = m2[:, perm]
    mask_p = create_mask(torch.from_numpy(np.ascontiguousarray(permuted)),
                         "m4n2_1d").numpy()
    mask = mask_p[:, invert_permutation(perm)].reshape(orig_shape)
    return mask, perm, base, best
