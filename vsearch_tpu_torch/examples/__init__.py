"""The repo's own tools on the port: the quick start
(``python -m vsearch_tpu_torch.examples.quick_start``), the convergence
demo (``python -m vsearch_tpu_torch.examples.train_demo``), the synthetic
vocabulary they share, and the wiki21m pipeline scripts under
``svdr_wiki21m/``. Each takes ``--device`` (``DEVICE`` in the scripts),
default ``cuda``."""
