"""Search CLIs: alpha (sparse), beta (bag-of-token + rerank) and dense."""
