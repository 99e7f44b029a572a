"""EntityMap: entity data keyed through a BiMap id space (port of the
reference's ``data/entity_map.py``; EntityMap.scala parity).

Entity string ids get contiguous integer indices (``data/bimap.BiMap``)
and each entity carries a data payload; ``to_rows`` walks them in int-id
order, the layout that stacks into ``[n_entities, ...]`` tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, Mapping, Tuple, TypeVar

from predictionio_tpu_torch.data.bimap import BiMap

T = TypeVar("T")
U = TypeVar("U")


class EntityMap(Generic[T]):
    """Immutable map entityId -> data with a contiguous int id space."""

    __slots__ = ("_data", "_id_map")

    def __init__(self, data: Mapping[str, T],
                 id_map: "BiMap[str, int] | None" = None):
        self._data: Dict[str, T] = dict(data)
        if id_map is None:
            id_map = BiMap.string_int(self._data.keys())
        elif set(id_map) != set(self._data):
            raise ValueError(
                "id_map keys must exactly match data keys "
                f"({len(set(self._data) - set(id_map))} data-only, "
                f"{len(set(id_map) - set(self._data))} map-only)")
        self._id_map = id_map

    # -- entity data access -------------------------------------------------
    def __getitem__(self, entity_id: str) -> T:
        return self._data[entity_id]

    def get(self, entity_id: str, default=None):
        return self._data.get(entity_id, default)

    def __contains__(self, entity_id: str) -> bool:
        return entity_id in self._data

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def items(self):
        return self._data.items()

    # -- id space -----------------------------------------------------------
    @property
    def id_map(self) -> "BiMap[str, int]":
        return self._id_map

    def entity_int_id(self, entity_id: str) -> int:
        return self._id_map[entity_id]

    def entity_id_of(self, int_id: int) -> str:
        return self._id_map.inverse()[int_id]

    def data_by_int_id(self, int_id: int) -> T:
        return self._data[self.entity_id_of(int_id)]

    # -- columnar construction ----------------------------------------------
    @classmethod
    def from_columnar(cls, entity_ids, payloads) -> "EntityMap[T]":
        """Build from parallel (entity_id, payload) columns, the shape a
        columnar scan hands over. Later rows win on duplicate ids; the id
        space is ``BiMap.string_int`` over the distinct ids."""
        return cls({str(e): p for e, p in zip(entity_ids, payloads)})

    # -- transforms ---------------------------------------------------------
    def map_values(self, fn: Callable[[T], U]) -> "EntityMap[U]":
        return EntityMap({k: fn(v) for k, v in self._data.items()},
                         self._id_map)

    def to_rows(self) -> Iterator[Tuple[str, int, T]]:
        """(entity_id, int_id, data) rows in int-id order."""
        inv = self._id_map.inverse()
        for i in range(len(self._id_map)):
            eid = inv[i]
            yield eid, i, self._data[eid]

    def __repr__(self) -> str:
        return f"EntityMap({len(self._data)} entities)"
