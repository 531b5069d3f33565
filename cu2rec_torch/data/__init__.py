from cu2rec_torch.data.csr import (
    CSRRatings, DeviceRatings, build_csr, csr_from_arrays, to_device,
)
from cu2rec_torch.data.ratings import (
    RatingsData, component_path, load_matrix, read_array, read_ratings_csv,
    write_component, write_csv, write_ratings_csv,
)

__all__ = [
    "RatingsData", "read_ratings_csv", "read_array", "load_matrix",
    "write_csv", "write_component", "component_path", "write_ratings_csv",
    "CSRRatings", "DeviceRatings", "build_csr", "csr_from_arrays",
    "to_device",
]
