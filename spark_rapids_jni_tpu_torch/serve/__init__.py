"""The serving layer (PyTorch port of ``serve/``).

Only the single-process range-shuffle driver is ported so far
(:mod:`serve.shuffle`); the executors, the supervisor and the cross-process
shuffle plane come with ROADMAP A.15.
"""
