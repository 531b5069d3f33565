"""Train/test splitting (reference preprocessing/split_to_test_train.py).

``split_true`` — global shuffle split, then re-sort by user (the mode the
reference actually uses, split_to_test_train.py:39-49); ``split_per_user``
— stratified per-user split (present but unused in the reference,
split_to_test_train.py:12-36).  Seeded and deterministic.
"""

from __future__ import annotations

import random


def split_true(rows, train_percent: float, seed: int | None = None):
    rng = random.Random(seed) if seed is not None else random
    rows = list(rows)
    rng.shuffle(rows)
    n = len(rows)
    cut = int(n * train_percent)
    train = sorted(rows[:cut], key=lambda x: x[0])
    test = sorted(rows[cut:], key=lambda x: x[0])
    return train, test


def split_per_user(rows, train_percent: float, seed: int | None = None):
    rng = random.Random(seed) if seed is not None else random
    user_to_ratings: dict = {}
    for r in rows:
        user_to_ratings.setdefault(r[0], []).append(r)
    train, test = [], []
    for user_id, ratings in user_to_ratings.items():
        ratings = list(ratings)
        rng.shuffle(ratings)
        cut = int(len(ratings) * train_percent)
        train.extend(ratings[:cut])
        test.extend(ratings[cut:])
    train.sort(key=lambda x: x[0])
    test.sort(key=lambda x: x[0])
    return train, test


def read_rating_rows(filename: str):
    """Read [userId, itemId, rating] rows, skipping the header
    (reference split_to_test_train.py:52-66)."""
    import csv
    rows = []
    with open(filename) as f:
        reader = csv.reader(f)
        next(reader, None)
        for row in reader:
            if row:
                rows.append([int(row[0]), int(row[1]), float(row[2])])
    return rows
