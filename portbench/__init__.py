"""The port's benchmark: ``BENCHMARK.json`` at the root names its cells,
and ``run.py`` runs one of them once on the card (see README.md)."""
