"""Sort a ratings CSV by (userId, itemId) — the CSR builder's precondition
(reference preprocessing/sort_ratings.py)."""

from __future__ import annotations

from cu2rec_torch.data.split import read_rating_rows
from cu2rec_torch.data.ratings import write_ratings_csv


def sort_rows(rows):
    return sorted(rows, key=lambda r: (r[0], r[1]))


def sort_ratings_file(filename_in: str, filename_out: str) -> None:
    write_ratings_csv(filename_out, sort_rows(read_rating_rows(filename_in)))
