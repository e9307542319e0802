"""Index-building CLIs: bag-of-token, sparse (alpha) and dense."""
