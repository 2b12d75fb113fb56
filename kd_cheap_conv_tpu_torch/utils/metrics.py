"""Streaming segmentation metrics — the reference's `StreamSegMetrics`
(the JAX package's utils/metrics.py): confusion-matrix accumulation giving
Overall Acc / Mean Acc / FreqW Acc / Mean IoU / Class IoU. numpy only.
`AverageMeter` is the reference's running average (step timing).

Two accumulation paths:
- host `update(label_trues, label_preds)` — the reference's API;
- device counts from train.steps.make_eval_step, fed to
  `from_confusion_matrix`.
"""

from __future__ import annotations

import numpy as np


class StreamSegMetrics:
    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.confusion_matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def update(self, label_trues, label_preds) -> None:
        for lt, lp in zip(label_trues, label_preds):
            self.confusion_matrix += self._fast_hist(
                np.asarray(lt).flatten(), np.asarray(lp).flatten())

    def _fast_hist(self, label_true, label_pred):
        mask = (label_true >= 0) & (label_true < self.n_classes)
        return np.bincount(
            self.n_classes * label_true[mask].astype(int) + label_pred[mask],
            minlength=self.n_classes ** 2,
        ).reshape(self.n_classes, self.n_classes)

    def get_results(self) -> dict:
        return self.from_confusion_matrix(self.confusion_matrix)

    @staticmethod
    def from_confusion_matrix(hist: np.ndarray) -> dict:
        hist = np.asarray(hist, dtype=np.float64)
        eps = 1e-12
        acc = np.diag(hist).sum() / max(hist.sum(), eps)
        acc_cls = np.diag(hist) / np.maximum(hist.sum(axis=1), eps)
        acc_cls = np.nanmean(np.where(hist.sum(axis=1) > 0, acc_cls, np.nan))
        denom = hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist)
        iu = np.diag(hist) / np.maximum(denom, eps)
        mean_iu = np.nanmean(np.where(denom > 0, iu, np.nan))
        freq = hist.sum(axis=1) / max(hist.sum(), eps)
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
        return {
            "Overall Acc": float(acc),
            "Mean Acc": float(acc_cls),
            "FreqW Acc": float(fwavacc),
            "Mean IoU": float(mean_iu),
            "Class IoU": dict(zip(range(hist.shape[0]), iu)),
        }

    def reset(self) -> None:
        self.confusion_matrix = np.zeros_like(self.confusion_matrix)

    @staticmethod
    def to_str(results: dict) -> str:
        return "\n".join(["Overall Acc: %f" % results["Overall Acc"],
                          "Mean Acc: %f" % results["Mean Acc"],
                          "FreqW Acc: %f" % results["FreqW Acc"],
                          "Mean IoU: %f" % results["Mean IoU"]])


class AverageMeter:
    """Running average (reference utils; used for step timing)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)
