"""Binary one-hot vectorizer (e2 parity; a copy of the reference's
``models/vectorizer.py``, numpy only).

Parity with e2/.../engine/BinaryVectorizer.scala:26-63: maps (property,
value) string pairs to indices of a binary feature vector; vectorization
over many rows is a single scatter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class BinaryVectorizer:
    property_map: Dict[Tuple[str, str], int]

    @property
    def num_features(self) -> int:
        return len(self.property_map)

    @classmethod
    def fit(cls, rows: Sequence[Dict[str, str]],
            properties: Sequence[str]) -> "BinaryVectorizer":
        """Collect distinct (property, value) pairs -> contiguous indices."""
        pairs = sorted({(p, str(row[p])) for row in rows
                        for p in properties if p in row})
        return cls(property_map={pair: i for i, pair in enumerate(pairs)})

    def to_vector(self, row: Dict[str, str]) -> np.ndarray:
        vec = np.zeros(self.num_features, np.float32)
        for key, value in row.items():
            idx = self.property_map.get((key, str(value)))
            if idx is not None:
                vec[idx] = 1.0
        return vec

    def to_matrix(self, rows: Sequence[Dict[str, str]]) -> np.ndarray:
        out = np.zeros((len(rows), self.num_features), np.float32)
        for i, row in enumerate(rows):
            for key, value in row.items():
                idx = self.property_map.get((key, str(value)))
                if idx is not None:
                    out[i, idx] = 1.0
        return out


# the e2 CrossValidation.splitData analog lives in core.cross_validation
# (shared by every engine's readEval); re-exported here because the e2
# module also shipped it next to the vectorizer
from predictionio_tpu_torch.core.cross_validation import split_data  # noqa: E402,F401
