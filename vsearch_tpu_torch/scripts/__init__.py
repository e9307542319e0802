"""The port's probes: counterparts of the repo's TPU probes
(``scripts/probe_*.py``, ``scripts/bitpack_regret_probe.py``), file by
file, on the card. Each is ``python -m vsearch_tpu_torch.scripts.<name>``
with ``--device`` (default ``cuda``; ``cpu`` runs the plain versions at a
size the host can hold and times nothing) and ``--seed``, prints one JSON
line and writes it to ``--out`` when given. ``main(argv)`` returns the
same dict."""
