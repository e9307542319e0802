"""Command-line entry points (``python -m vsearch_tpu_torch.cli.*``):
index builds, searches, the HTTP server and checkpoint conversion. Each
takes ``--device`` (default ``cuda``); ``--device cpu`` runs the whole
path on the host."""
