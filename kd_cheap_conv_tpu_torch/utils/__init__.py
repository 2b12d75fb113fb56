from .metrics import StreamSegMetrics

__all__ = ["StreamSegMetrics"]
