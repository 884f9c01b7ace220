"""Metrics: EER, min t-DCF and deployment calibration of score files, and
the training loop's ``AverageMeter`` and ``EarlyStopping``. The port's own
copy of ``rtdsd_tpu/utils/metrics.py`` (numpy only).

EER is where FAR crosses FRR on the sorted-score sweep, linearly
interpolated, which matches sklearn's ROC with a brentq root-find to float
precision.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np


def compute_eer(scores: np.ndarray, labels: np.ndarray, pos_label: int = 1) -> float:
    """Equal error rate in percent.

    ``scores``: higher = more likely bonafide (positive class).
    ``labels``: 1 = bonafide, 0 = spoof (the reference's convention).

    Matches ``brentq(lambda x: 1 - x - interp1d(fpr, tpr)(x))``
    (the reference trainer's definition) to float precision: we find the
    crossing of FNR (=1-TPR) and FPR along the ROC curve and linearly
    interpolate between the two bracketing thresholds.
    """
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel()
    n_pos = int(np.sum(labels == pos_label))
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("compute_eer needs both positive and negative trials")

    # Sweep the accept-threshold down the score-sorted trials: FPR rises from
    # 0 to 1, FNR falls from 1 to 0; EER is at the crossing.
    order = np.argsort(-scores, kind="mergesort")
    is_pos = (labels[order] == pos_label).astype(np.float64)
    tp = np.cumsum(is_pos)
    fp = np.cumsum(1.0 - is_pos)
    fpr = fp / n_neg
    fnr = 1.0 - tp / n_pos

    # Find first index where FNR <= FPR, interpolate between it and previous.
    diff = fnr - fpr
    idx = int(np.argmax(diff <= 0))
    if idx == 0:
        eer = (fpr[0] + fnr[0]) / 2.0
    else:
        # Linear interpolation of the crossing point between idx-1 and idx.
        d0, d1 = diff[idx - 1], diff[idx]
        t = d0 / (d0 - d1) if d0 != d1 else 0.5
        eer = (1 - t) * fpr[idx - 1] + t * fpr[idx]
        eer_f = (1 - t) * fnr[idx - 1] + t * fnr[idx]
        eer = (eer + eer_f) / 2.0
    return float(eer * 100.0)


def calibrate_scores(scores: np.ndarray, labels: np.ndarray, *,
                     target_fars=(0.01, 0.05, 0.10),
                     target_frrs=(),
                     platt_iters: int = 50) -> dict:
    """Deployment calibration from a labeled dev set.

    The reference stops at raw CM score files; a deployment needs an
    operating point (accept threshold) and, often, calibrated
    probabilities. Returns a dict with:

    - ``eer_pct`` / ``eer_threshold``: the equal-error operating point
      (accept when ``score >= threshold``);
    - ``at_far`` / ``at_frr``: for each requested rate, the threshold
      whose achieved FAR (spoof accepted) / FRR (bonafide rejected) is
      the largest value <= the target, with both achieved rates;
    - ``platt_a`` / ``platt_b``: Platt scaling
      ``P(bonafide | s) = sigmoid(a*s + b)`` fit by Newton-Raphson on
      the log-loss with Platt's label smoothing (so a separable dev set
      cannot push ``a`` to infinity).

    ``labels``: 1 = bonafide, 0 = spoof (reference convention).
    """
    s = np.asarray(scores, np.float64).ravel()
    y = np.asarray(labels).ravel().astype(np.int64)
    bona, spoof = s[y == 1], s[y == 0]
    if len(bona) == 0 or len(spoof) == 0:
        raise ValueError("calibration needs both bonafide and spoof trials")

    # candidate thresholds: every distinct score plus one above the max
    # (accept-none); FAR falls and FRR rises as the threshold increases
    cand = np.unique(s)
    cand = np.append(cand, cand[-1] + 1.0)
    far = (spoof[None, :] >= cand[:, None]).mean(axis=1) \
        if len(s) * len(cand) <= 10 ** 7 else \
        np.array([(spoof >= t).mean() for t in cand])
    frr = (bona[None, :] < cand[:, None]).mean(axis=1) \
        if len(s) * len(cand) <= 10 ** 7 else \
        np.array([(bona < t).mean() for t in cand])

    i = int(np.argmin(np.abs(far - frr)))
    out = {
        "eer_pct": compute_eer(s, y),
        "eer_threshold": float(cand[i]),
        "eer_far": float(far[i]),
        "eer_frr": float(frr[i]),
        "at_far": {},
        "at_frr": {},
    }
    for x in target_fars:
        ok = np.nonzero(far <= x)[0]
        j = int(ok[0])  # smallest threshold meeting the FAR budget
        out["at_far"][x] = {"threshold": float(cand[j]),
                            "far": float(far[j]), "frr": float(frr[j])}
    for x in target_frrs:
        ok = np.nonzero(frr <= x)[0]
        j = int(ok[-1])  # largest threshold meeting the FRR budget
        out["at_frr"][x] = {"threshold": float(cand[j]),
                            "far": float(far[j]), "frr": float(frr[j])}

    # ---- Platt scaling (Platt 1999): smoothed targets keep the fit
    # finite on separable data
    n_pos, n_neg = len(bona), len(spoof)
    t_pos = (n_pos + 1.0) / (n_pos + 2.0)
    t_neg = 1.0 / (n_neg + 2.0)
    t = np.where(y == 1, t_pos, t_neg)

    def nll(a_, b_):
        z = a_ * s + b_
        # stable smoothed log-loss: t*softplus(-z) + (1-t)*softplus(z)
        return float(np.mean(t * np.logaddexp(0.0, -z)
                             + (1.0 - t) * np.logaddexp(0.0, z)))

    # Newton-Raphson with a backtracking line search: on small/separable
    # dev sets a raw Newton step can overshoot into the sigmoid's flat
    # tails (curvature ~0 -> enormous steps, a -> 1e9 while the LOSS gets
    # WORSE); only steps that decrease the smoothed log-loss are taken,
    # so the fit lands at the smoothing-bounded optimum instead.
    a, b = 1.0, 0.0
    loss = nll(a, b)
    for _ in range(platt_iters):
        z = np.clip(a * s + b, -60.0, 60.0)
        p = 1.0 / (1.0 + np.exp(-z))
        g = p - t  # d loss / d z
        w = np.maximum(p * (1.0 - p), 1e-12)
        ga = float(np.dot(g, s))
        gb = float(np.sum(g))
        haa = float(np.dot(w, s * s)) + 1e-9
        hab = float(np.dot(w, s))
        hbb = float(np.sum(w)) + 1e-9
        det = haa * hbb - hab * hab
        if abs(det) < 1e-18:
            break
        da = (hbb * ga - hab * gb) / det
        db = (haa * gb - hab * ga) / det
        step = 1.0
        for _ in range(40):
            na, nb = a - step * da, b - step * db
            nl = nll(na, nb)
            if nl <= loss:
                break
            step *= 0.5
        else:
            break  # no improving step in this direction: converged
        moved = step * (abs(da) + abs(db))
        a, b, loss = na, nb, nl
        if moved < 1e-12:
            break
    out["platt_a"] = float(a)
    out["platt_b"] = float(b)
    return out


def load_calibration(path: str) -> dict:
    """Load a calibration produced by ``cli.evaluate --calibrate``
    (one JSON object: Platt coefficients + operating-point thresholds).
    Raises with the missing keys when handed some other JSON file."""
    import json

    with open(path) as f:
        cal = json.load(f)
    missing = [k for k in ("platt_a", "platt_b", "eer_threshold")
               if k not in cal]
    if missing:
        raise ValueError(
            f"{path} is not a calibration file (missing {missing}); "
            "produce one with: python -m rtdsd_tpu_torch.cli.evaluate "
            "--scores dev_scores.txt --protocol dev.txt --calibrate")
    return cal


def load_cascade_calibration(path: str) -> dict:
    """Load a cascade band calibration produced by ``cli.evaluate
    --cascade-sweep ... --cascade-out`` (band/center chosen on a dev set;
    consumed by the JAX package's ``cli.serve`` / ``cli.daemon`` / ``cli.export``
    ``--cascade_calibration``). Raises with the missing keys when handed
    some other JSON file."""
    import json

    with open(path) as f:
        cal = json.load(f)
    missing = [k for k in ("band", "center") if k not in cal]
    if missing:
        raise ValueError(
            f"{path} is not a cascade calibration file (missing "
            f"{missing}); produce one with: python -m rtdsd_tpu_torch.cli."
            "evaluate --scores screener_dev.txt --protocol dev.txt "
            "--cascade-sweep flagship_dev.txt --cascade-out band.json")
    return cal


def platt_prob(scores, cal: dict):
    """Calibrated ``P(bonafide | score)`` under the Platt fit in ``cal``.
    Accepts a scalar or array; returns the same shape as float64."""
    s = np.asarray(scores, np.float64)
    z = np.clip(cal["platt_a"] * s + cal["platt_b"], -60.0, 60.0)
    return 1.0 / (1.0 + np.exp(-z))


def calibration_threshold(cal: dict, operating_point: str = "eer") -> float:
    """Accept-threshold for a named operating point: ``"eer"``,
    ``"far=0.01"`` or ``"frr=0.05"`` (rates as configured at calibration
    time; available points are listed in the error message)."""
    if operating_point == "eer":
        return float(cal["eer_threshold"])
    for prefix, table in (("far=", "at_far"), ("frr=", "at_frr")):
        if operating_point.startswith(prefix):
            rate = operating_point[len(prefix):]
            entry = cal.get(table, {}).get(rate)
            if entry is None:
                # calibrate_scores keys by float; the CLI re-keys by the
                # %g-printed rate — accept either spelling
                try:
                    entry = cal.get(table, {}).get(f"{float(rate):g}")
                except ValueError:
                    entry = None
            if entry is not None:
                return float(entry["threshold"])
            have = ["eer"] + [f"far={k}" for k in cal.get("at_far", {})] \
                + [f"frr={k}" for k in cal.get("at_frr", {})]
            raise ValueError(
                f"operating point {operating_point!r} not in this "
                f"calibration; available: {have}")
    raise ValueError(
        f"bad operating point {operating_point!r} "
        "(use 'eer', 'far=<rate>' or 'frr=<rate>')")


def compute_min_tdcf(cm_scores: np.ndarray, labels: np.ndarray, *,
                     p_tar: float = 0.9405, p_non: float = 0.0095,
                     p_spoof: float = 0.05, c_miss: float = 1.0,
                     c_fa: float = 10.0, c_fa_spoof: float = 10.0,
                     pmiss_asv: float = 0.0, pfa_asv: float = 0.0,
                     pmiss_spoof_asv: float = 0.0) -> float:
    """Normalized minimum tandem detection cost (min t-DCF).

    The reference delegates this to the official external ASVspoof package
    (its README); here the CM-constrained t-DCF is
    computed in-framework from first principles (tandem ASV->CM gating,
    Kinnunen et al. 2020). With the ASV fixed at its operating point
    (``pmiss_asv``/``pfa_asv`` on target/non-target trials,
    ``pmiss_spoof_asv`` = fraction of spoof trials the ASV rejects — take
    these three numbers from the official ASV scores), a CM threshold s
    yields:

      target missed   : Pmiss_asv + (1 - Pmiss_asv) * Pmiss_cm(s)
      nontarget passed: Pfa_asv * (1 - Pmiss_cm(s))
      spoof passed    : (1 - Pmiss_spoof_asv) * Pfa_cm(s)

    so t-DCF(s) = C0 + C1*Pmiss_cm(s) + C2*Pfa_cm(s) with

      C0 = p_tar*c_miss*Pmiss_asv + p_non*c_fa*Pfa_asv
      C1 = p_tar*c_miss*(1 - Pmiss_asv) - p_non*c_fa*Pfa_asv
      C2 = p_spoof*c_fa_spoof*(1 - Pmiss_spoof_asv)

    normalized by the best trivial CM, C0 + min(C1, C2) (accept-all costs
    C0+C2, reject-all C0+C1). Priors/costs default to the ASVspoof LA cost
    model (p_tar = 0.99*0.95, p_non = 0.01*0.95, p_spoof = 0.05). With a
    perfect ASV (the all-zero default) this reduces to the pure-CM DCF.
    """
    scores = np.asarray(cm_scores, np.float64).ravel()
    labels = np.asarray(labels).ravel()
    bona = np.sort(scores[labels == 1])
    spoof = np.sort(scores[labels == 0])
    if len(bona) == 0 or len(spoof) == 0:
        raise ValueError("min t-DCF needs both bonafide and spoof trials")

    c0 = p_tar * c_miss * pmiss_asv + p_non * c_fa * pfa_asv
    c1 = p_tar * c_miss * (1.0 - pmiss_asv) - p_non * c_fa * pfa_asv
    c2 = p_spoof * c_fa_spoof * (1.0 - pmiss_spoof_asv)
    norm = c0 + min(c1, c2)
    if norm <= 0:
        raise ValueError("degenerate cost model: C0 + min(C1, C2) <= 0")

    # Sweep thresholds at every distinct score: Pmiss_cm = fraction of
    # bonafide below s, Pfa_cm = fraction of spoof at/above s.
    thresholds = np.concatenate([[-np.inf], np.unique(scores), [np.inf]])
    pmiss_cm = np.searchsorted(bona, thresholds, side="left") / len(bona)
    pfa_cm = 1.0 - np.searchsorted(spoof, thresholds, side="left") / len(spoof)
    tdcf = c0 + c1 * pmiss_cm + c2 * pfa_cm
    return float(np.min(tdcf) / norm)


class AverageMeter:
    """Running weighted average."""

    def __init__(self, name: str = "meter", fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:.6f} ({self.avg:.6f})"


class EarlyStopping:
    """Early stopping on a lower-is-better metric with best-checkpoint
    rotation: ``save_fn(path)`` writes the checkpoint of a new best under
    ``{save_dir}/{prefix}_{epoch}``, and the previous best is removed."""

    def __init__(self, patience: int = 7, verbose: bool = False,
                 delta: float = 0.0, save_dir: str = ".",
                 prefix: str = "best_checkpoint"):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.save_dir = save_dir
        self.prefix = prefix
        self.counter = 0
        self.best_score: Optional[float] = None
        self.early_stop = False
        self.best_path: Optional[str] = None

    def __call__(self, metric: float, epoch: int, save_fn) -> bool:
        """Returns True if ``metric`` improved on the best."""
        score = -metric
        if self.best_score is None or score > self.best_score + self.delta:
            self.best_score = score
            path = os.path.join(self.save_dir, f"{self.prefix}_{epoch}")
            os.makedirs(self.save_dir, exist_ok=True)
            save_fn(path)
            if (self.best_path and self.best_path != path
                    and os.path.exists(self.best_path)):
                shutil.rmtree(self.best_path, ignore_errors=True)
            self.best_path = path
            self.counter = 0
            return True
        self.counter += 1
        if self.counter >= self.patience:
            self.early_stop = True
        return False
