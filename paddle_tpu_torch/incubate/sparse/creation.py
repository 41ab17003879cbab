"""``incubate/sparse/creation.py`` names."""
from ...sparse import sparse_coo_tensor, sparse_csr_tensor  # noqa: F401
