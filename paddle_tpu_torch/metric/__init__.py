"""Metrics (port of paddle_tpu/metric): the ``Metric`` base and
``Accuracy``, ``Precision``, ``Recall``, ``Auc`` that ``hapi.Model``
updates, over torch tensors (read to the host) or numpy arrays, and the
functional ``accuracy`` on the tensors' device."""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        """Optional pre-processing hook run on device outputs."""
        return pred, label


class Accuracy(Metric):
    """reference: metric/metrics.py Accuracy (top-k)."""

    def __init__(self, topk=(1,), name="acc"):
        super().__init__(name)
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self.reset()

    def reset(self):
        self.correct = np.zeros(len(self.topk))
        self.total = 0

    def compute(self, pred, label, *args):
        p = _np(pred)
        lbl = _np(label).reshape(-1)
        k = max(self.topk)
        top = np.argsort(-p, axis=-1)[..., :k].reshape(len(lbl), k)
        return top, lbl

    def update(self, correct, label=None):
        if label is not None:
            top, lbl = correct, label
        else:
            top, lbl = correct
        top = _np(top)
        lbl = _np(lbl).reshape(-1)
        for i, k in enumerate(self.topk):
            self.correct[i] += (top[:, :k] == lbl[:, None]).any(-1).sum()
        self.total += len(lbl)
        return self.correct[0] / max(self.total, 1)

    def accumulate(self):
        acc = [c / max(self.total, 1) for c in self.correct]
        return acc[0] if len(acc) == 1 else acc


class Precision(Metric):
    """Binary precision (reference: metrics.py Precision)."""

    def __init__(self, name="precision"):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds).reshape(-1) > 0.5).astype(np.int64)
        y = _np(labels).reshape(-1).astype(np.int64)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fp += int(((p == 1) & (y == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds).reshape(-1) > 0.5).astype(np.int64)
        y = _np(labels).reshape(-1).astype(np.int64)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fn += int(((p == 0) & (y == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)


class Auc(Metric):
    """Approximate ROC-AUC via histogram buckets
    (reference: metrics.py Auc num_thresholds binning)."""

    def __init__(self, num_thresholds=4095, name="auc"):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1)
        self._neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        y = _np(labels).reshape(-1)
        idx = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        np.add.at(self._pos, idx[y == 1], 1)
        np.add.at(self._neg, idx[y == 0], 1)

    def accumulate(self):
        tot_pos = self._pos.sum()
        tot_neg = self._neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # integrate TPR over FPR from the histogram (trapezoid)
        pos_c = np.cumsum(self._pos[::-1])
        neg_c = np.cumsum(self._neg[::-1])
        tpr = pos_c / tot_pos
        fpr = neg_c / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
        return float(trapezoid(tpr, fpr))


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    """Functional top-k accuracy: a 0-dim fp32 tensor on ``input``'s
    device (ties ranked by index, as JAX's stable argsort)."""
    pred = input if torch.is_tensor(input) else torch.as_tensor(input)
    lbl = (label if torch.is_tensor(label)
           else torch.as_tensor(label)).reshape(-1).to(pred.device)
    topk = torch.argsort(-pred, dim=-1, stable=True)[:, :k]
    hit = (topk == lbl[:, None]).any(dim=-1)
    return hit.float().mean()
