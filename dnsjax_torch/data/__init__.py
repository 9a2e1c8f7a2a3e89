"""RGB-D sequence readers: the port's own copy of dnsjax/data."""

from dnsjax_torch.data.base import BaseDataset, get_dataset  # noqa: F401
from dnsjax_torch.data.synthetic import SyntheticDataset  # noqa: F401
