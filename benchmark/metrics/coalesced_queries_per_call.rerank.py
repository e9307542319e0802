"""``coalesced_queries_per_call`` in a beta-search (rerank) cell, where the
end-to-end metric it moves is ``qps``: the same reading."""
from benchmark.harness import load_reader

read = load_reader("coalesced_queries_per_call")
