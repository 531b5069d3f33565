from cu2rec_torch.data.csr import CSRRatings, build_csr, csr_from_arrays
from cu2rec_torch.data.ratings import RatingsData, read_ratings_csv

__all__ = ["CSRRatings", "RatingsData", "build_csr", "csr_from_arrays",
           "read_ratings_csv"]
