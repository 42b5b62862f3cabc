"""Membership-inference attack (MIA) evaluation — the paper's privacy metric
(``repro.fl.mia`` on torch).

Protocol (threshold/shadow-free variant of [Shokri et al. 2017] as used by
FedEraser): an attack classifier (logistic regression on output-derived
features: loss, max-prob, entropy) is trained to separate *member* (retained
clients' training data) from *non-member* (held-out test data) under the
target model.  It is then evaluated on the *forgotten* client's data: the F1
score of the attack claiming "member" on forgotten data measures how much the
unlearned model still remembers.  Lower = better unlearning; a fully
retrained model scores near the no-information rate.

The features come from the device: each batch runs once through the K-model
ensemble as one stack (``stacked_predict``), and the task turns the mean fp32
logits into features.  The attack itself is numpy float64, the reference's
arithmetic carried over unchanged.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.fl.simulator import _stack, mean_logits
from repro_torch.fl.tasks import resolve_task


@torch.no_grad()
def _features(predict, models: Dict[int, object], make_batch, xs, ys,
              task, batch: int = 200) -> np.ndarray:
    """Per-example [nll, max_prob, entropy] under the (ensemble) model.

    ``predict`` is a stacked predict (``PredictInterface.stacked_predict``):
    the K models of ``models`` run as one stack over each batch of ``(xs,
    ys)``.  The per-example feature shape is the task's
    (``TaskSpec.mia_features``); ``task`` may be a ``TaskSpec`` instance,
    class, or registered name."""
    spec = resolve_task(task)
    stacked = _stack(list(models.values()))
    device = tree_leaves(stacked)[0].device
    feats = []
    for i in range(0, len(xs), batch):
        x = torch.from_numpy(np.ascontiguousarray(xs[i:i + batch]))
        y = torch.from_numpy(np.ascontiguousarray(ys[i:i + batch]))
        x, y = x.to(device), y.to(device)
        logits = mean_logits(predict, make_batch, stacked, len(models), x, y)
        feats.append(spec.mia_features(logits, y).cpu().numpy())
    return np.concatenate(feats, axis=0)


def attack_f1(member_flags: np.ndarray, nonmember_flags: np.ndarray) -> float:
    """F1 of an attack claiming 'member' on forgotten data, with the false
    positives measured on an equally sized true non-member split — shared by
    the threshold attack below and the shadow-model attack in
    ``repro_torch.verify.shadow``.  ``member_flags``: attack decisions (1 =
    'member') on the forgotten data; ``nonmember_flags``: decisions on true
    non-members."""
    n_eval = len(member_flags)
    tp = int(np.sum(member_flags))        # forgotten flagged as member
    fp = int(np.sum(nonmember_flags))     # true non-members flagged as member
    fn = n_eval - tp
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return float(2 * prec * rec / max(prec + rec, 1e-9))


def _logreg_fit(x: np.ndarray, y: np.ndarray, steps: int = 400,
                lr: float = 0.5):
    """Tiny logistic regression (numpy GD) with feature standardisation."""
    mu, sd = x.mean(0), x.std(0) + 1e-9
    xs = (x - mu) / sd
    w = np.zeros(x.shape[1])
    b = 0.0
    for _ in range(steps):
        z = xs @ w + b
        p = 1 / (1 + np.exp(-z))
        g = p - y
        w -= lr * (xs.T @ g) / len(y)
        b -= lr * g.mean()
    return (w, b, mu, sd)


def _logreg_score(model, x: np.ndarray) -> np.ndarray:
    w, b, mu, sd = model
    return ((x - mu) / sd) @ w + b


def _logreg_predict(model, x: np.ndarray, threshold: float) -> np.ndarray:
    """Balanced-threshold decision: the attacker flags the top half of its
    score distribution as 'member' (standard MIA practice — under no signal
    this yields the no-information F1 ~ 0.5 instead of degenerate 0/1)."""
    return (_logreg_score(model, x) > threshold).astype(np.int64)


def mia_f1(predict, models: Dict[int, object], make_batch, task,
           member_data, nonmember_data, forgotten_data) -> float:
    """F1 of the attack detecting *forgotten* examples as members.

    member/nonmember/forgotten: (xs, ys) tuples; ``predict`` a stacked
    predict.  Returns F1 in [0,1]; the paper reports this with a down arrow
    (lower = data better forgotten).
    """
    fx_m = _features(predict, models, make_batch, *member_data, task)
    fx_n = _features(predict, models, make_batch, *nonmember_data, task)
    x = np.concatenate([fx_m, fx_n])
    y = np.concatenate([np.ones(len(fx_m)), np.zeros(len(fx_n))])
    attack = _logreg_fit(x, y)
    threshold = float(np.median(_logreg_score(attack, x)))

    fx_f = _features(predict, models, make_batch, *forgotten_data, task)
    n_eval = min(len(fx_f), len(fx_n))
    pred_f = _logreg_predict(attack, fx_f[:n_eval], threshold)  # 1 = "member"
    pred_n = _logreg_predict(attack, fx_n[:n_eval], threshold)
    # attack's positive class = member; forgotten data SHOULD be non-member.
    return attack_f1(pred_f, pred_n)
