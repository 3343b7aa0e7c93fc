"""The benchmark of the PyTorch and CUDA port: TPC-DS queries as Spark task
streams on the card.  ``run.py`` runs one cell of ``BENCHMARK.json`` once."""
