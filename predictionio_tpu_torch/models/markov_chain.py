"""Markov chain transition model (e2 parity; a copy of the reference's
``models/markov_chain.py``, numpy only).

Parity with e2/.../engine/MarkovChain.scala:25-87: from (i, j, count)
transition observations build a row-normalized transition matrix keeping the
top-N entries per row; predict(current_state) returns that row's top
transitions. Normalization/top-N are vectorized.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class MarkovChainModel:
    """n states; per-row top-N (next_state, probability) lists."""

    n_states: int
    top_n: int
    transitions: Dict[int, List[Tuple[int, float]]]

    def predict(self, current_state: int) -> List[Tuple[int, float]]:
        return self.transitions.get(current_state, [])


def train_markov_chain(src: np.ndarray, dst: np.ndarray, counts: np.ndarray,
                       n_states: int, top_n: int) -> MarkovChainModel:
    """MarkovChain.train parity over COO (src, dst, count) observations."""
    # aggregate duplicate (src, dst) entries
    keys = src.astype(np.int64) * n_states + dst.astype(np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    agg = np.zeros(len(uniq), np.float64)
    np.add.at(agg, inv, counts)
    s = (uniq // n_states).astype(np.int64)
    d = (uniq % n_states).astype(np.int64)
    row_sum = np.zeros(n_states, np.float64)
    np.add.at(row_sum, s, agg)
    prob = agg / row_sum[s]

    transitions: Dict[int, List[Tuple[int, float]]] = {}
    order = np.lexsort((-prob, s))
    for idx in order:
        row = int(s[idx])
        lst = transitions.setdefault(row, [])
        if len(lst) < top_n:
            lst.append((int(d[idx]), float(prob[idx])))
    return MarkovChainModel(n_states=n_states, top_n=top_n,
                            transitions=transitions)
