from .metrics import AverageMeter, StreamSegMetrics

__all__ = ["AverageMeter", "StreamSegMetrics"]
