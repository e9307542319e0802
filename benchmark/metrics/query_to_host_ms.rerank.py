"""``query_to_host_ms`` in a beta-search (rerank) cell, where the
end-to-end metric it moves is ``qps``: the same reading."""
from benchmark.harness import load_reader

read = load_reader("query_to_host_ms")
