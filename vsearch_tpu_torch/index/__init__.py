"""Index layer: dense, sparse (ELL), and bag-of-token binary indexes."""
from .base import DenseIndex, Index, IndexType, SearchResults
from .sparse import BoTIndex, SparseIndex

__all__ = ["DenseIndex", "Index", "IndexType", "SearchResults",
           "SparseIndex", "BoTIndex"]
