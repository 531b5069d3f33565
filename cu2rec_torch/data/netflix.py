"""Netflix-prize format mapping (reference preprocessing/map_netflix.py).

Netflix training files are space-delimited, headerless, with the rating
in column 3; test rows referencing unseen users/items are dropped via
``add_missing=False`` (map_netflix.py:9-28).  Rides the vectorized
mapper (data/mapping.py) end-to-end.
"""

from __future__ import annotations

from cu2rec_torch.data.mapping import map_file, sort_by_user, write_mapped_csv


def process_netflix(train_in: str, train_out: str,
                    test_in: str | None = None, test_out: str | None = None,
                    delimiter: str = " ") -> None:
    user_mapping: dict = {}
    item_mapping: dict = {}
    mu, mi, r = map_file(train_in, user_mapping, item_mapping,
                         delimiter=delimiter, has_header=False,
                         add_missing=True)
    write_mapped_csv(train_out, *sort_by_user(mu, mi, r))
    if test_in and test_out:
        mu, mi, r = map_file(test_in, user_mapping, item_mapping,
                             delimiter=delimiter, has_header=False,
                             add_missing=False)
        write_mapped_csv(test_out, *sort_by_user(mu, mi, r))
