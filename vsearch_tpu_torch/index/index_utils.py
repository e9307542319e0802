"""Small index helpers (counterpart of ``vsearch_tpu/index/index_utils.py``,
itself after the reference's src/ir/retriever/index_utils.py:12-20)."""
from __future__ import annotations

from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")


def get_first_unique_n(iterable: Iterable[T], n: int) -> Iterator[T]:
    """Yield the first ``n`` unique elements in encounter order."""
    seen = set()
    for item in iterable:
        if item not in seen:
            seen.add(item)
            yield item
            if len(seen) == n:
                return
