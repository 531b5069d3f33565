"""Probes of the card, each the port of a probe in the repository's
``experiments/``: they print one JSON line per measurement and write a file
only when given ``--out``.  They run on a CUDA device only."""
