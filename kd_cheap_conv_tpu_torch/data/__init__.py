from .pipeline import make_loader, prefetch_to_device
from .synthetic import SyntheticSegmentation

__all__ = ["SyntheticSegmentation", "make_loader", "prefetch_to_device"]
