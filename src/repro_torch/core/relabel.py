"""Id permutation helper for locality-relabeled index directories (copy
of `repro.core.relabel.invert_permutation`; the device loader needs only
the inverse to map a relabeled directory back to original ids)."""
from __future__ import annotations

import numpy as np


def invert_permutation(old_to_new: np.ndarray) -> np.ndarray:
    """old->new map -> new->old map (both are permutations of arange(n))."""
    old_to_new = np.asarray(old_to_new, dtype=np.int64)
    new_to_old = np.empty_like(old_to_new)
    new_to_old[old_to_new] = np.arange(old_to_new.size, dtype=np.int64)
    return new_to_old
