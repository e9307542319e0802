"""Data pipeline: datasets, deterministic sharded iterators, batching
(counterpart of ``vsearch_tpu/data``)."""
from .batching import BiEncoderBatch, create_biencoder_batch
from .dataset import (BiEncoderDataset, BiEncoderPassage, BiEncoderSample,
                      create_biencoder_passage)
from .iterators import (LocalShardedDataIterator, MultiSetDataIterator,
                        ShardedDataIterator, get_data_iterator)
from .rag_dataset import RAGDataset

__all__ = [
    "BiEncoderBatch", "create_biencoder_batch",
    "BiEncoderDataset", "BiEncoderPassage", "BiEncoderSample",
    "create_biencoder_passage",
    "ShardedDataIterator", "LocalShardedDataIterator",
    "MultiSetDataIterator", "get_data_iterator",
    "RAGDataset",
]
