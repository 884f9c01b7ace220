"""Score-file evaluation: EER from CM score files + protocol labels. The
port's own copy of ``rtdsd_tpu/cli/evaluate.py``, with the same 22 flags,
prints and files:

    python -m rtdsd_tpu_torch.cli.evaluate --scores runs/scores_DF21.txt \\
        --config cfg.yaml --track DF21
    python -m rtdsd_tpu_torch.cli.evaluate --scores s.txt \\
        --protocol labels.txt --file-field 1 --label-field 5

Score file format: ``utt_id score`` per line (bonafide logit, higher =
more bonafide). Prints EER% and counts; ``--tdcf`` adds normalized min
t-DCF (pass the official ASV operating point via --pmiss-asv / --pfa-asv /
--pmiss-spoof-asv; the ASV scores themselves only ship with the official
package, the cost math is in utils/metrics.py::compute_min_tdcf).

``--calibrate`` turns a labeled dev score file into a deployment
operating point (JSON): the EER threshold, accept thresholds meeting
``--target-far`` / ``--target-frr`` budgets with both achieved rates,
and Platt scaling coefficients for calibrated probabilities
``P(bonafide|s) = sigmoid(a*s + b)`` (utils/metrics.py::calibrate_scores).

``--fuse other.txt ...`` fuses systems (weighted sum of z-normalized
scores over the common trials, ``--fuse-weights`` / ``--fuse-norm``):
with a protocol it prints per-system and fused EER; ``--fuse-out``
writes the fused score file (works without labels too — submission
building).

``--cascade-sweep flagship_scores.txt`` calibrates a cascade band from a
dev set entirely offline: score the set once with the screener (--scores)
and once with the flagship, and the sweep prints escalation rate and
cascade EER per candidate band — pick the smallest band whose cascade
EER matches the flagship row, pass it to ``--cascade_band``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rtdsd_tpu_torch.utils.metrics import compute_eer


def read_scores(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = float(parts[1])
    return out


def labels_from_protocol(path: str, file_field: int, label_field: int) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) <= max(file_field, label_field):
                continue
            out[parts[file_field]] = 1 if parts[label_field] == "bonafide" else 0
    return out


# per-track protocol field indices (matching data/protocols.py)
TRACK_FIELDS = {
    "LA19": (1, 4), "LA21": (1, 4), "DF21": (1, 5),
    "InTheWild": (0, 1), "ASVspoof5": (0, 2),
}
TRACK_PROTOCOL_ATTR = {
    "LA19": "path_label_asv_spoof_2019_la_eval",
    "LA21": "path_label_asv_spoof_2021_la_eval",
    "DF21": "path_label_asv_spoof_2021_df_eval",
    "InTheWild": "path_label_in_the_wild",
    "ASVspoof5": "path_label_asvspoof5",
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scores", required=True)
    p.add_argument("--protocol", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--track", default=None, choices=list(TRACK_FIELDS))
    p.add_argument("--file-field", type=int, default=None)
    p.add_argument("--label-field", type=int, default=None)
    p.add_argument("--tdcf", action="store_true", default=False,
                   help="also print normalized min t-DCF")
    p.add_argument("--pmiss-asv", type=float, default=0.0,
                   help="ASV miss rate at its operating point")
    p.add_argument("--pfa-asv", type=float, default=0.0,
                   help="ASV false-accept rate on nontargets")
    p.add_argument("--pmiss-spoof-asv", type=float, default=0.0,
                   help="fraction of spoof trials the ASV rejects")
    p.add_argument("--cascade-sweep", default=None, metavar="FLAGSHIP_SCORES",
                   help="calibrate a cascade band offline: --scores is the "
                        "screener's score file, this the flagship's (same "
                        "trials); prints escalation rate + cascade EER per "
                        "band so you can pick --cascade_band")
    p.add_argument("--cascade-center", type=float, default=0.0)
    p.add_argument("--cascade-out", default=None, metavar="JSON",
                   help="with --cascade-sweep: choose a band on a dense "
                        "sweep and write it (+ center, rates, EERs) as a "
                        "sidecar that cli.serve / cli.daemon / cli.export "
                        "consume via --cascade_calibration — the one-"
                        "command re-calibration flow after a screener "
                        "change")
    p.add_argument("--cascade-pick-esc", type=float, default=None,
                   help="with --cascade-out: pick the band at this target "
                        "escalation fraction instead of the EER rule")
    p.add_argument("--cascade-pick-tol", type=float, default=0.02,
                   help="EER pick rule: smallest band whose cascade EER "
                        "is within this RELATIVE margin of the best "
                        "cascade EER over the dense sweep (default 2%%)")
    p.add_argument("--calibrate", action="store_true", default=False,
                   help="print a deployment operating point as JSON: EER "
                        "threshold, thresholds at --target-far/--target-frr"
                        " budgets, and Platt scaling (a, b) for "
                        "P(bonafide|s) = sigmoid(a*s + b)")
    p.add_argument("--target-far", type=float, nargs="*",
                   default=[0.01, 0.05, 0.10],
                   help="FAR budgets (fractions) for --calibrate")
    p.add_argument("--target-frr", type=float, nargs="*", default=[],
                   help="FRR budgets (fractions) for --calibrate")
    p.add_argument("--fuse", nargs="+", default=None, metavar="SCORES",
                   help="fuse --scores with these score file(s): "
                        "weighted sum of (optionally z-normalized) "
                        "per-system scores over the common trials — "
                        "standard ASVspoof system fusion. With a "
                        "protocol, prints per-system and fused EER; "
                        "--fuse-out writes the fused score file either "
                        "way")
    p.add_argument("--fuse-weights", type=float, nargs="*", default=None,
                   help="one weight per system, --scores first "
                        "(default: equal)")
    p.add_argument("--fuse-norm", default="zscore",
                   choices=("zscore", "none"),
                   help="per-system normalization before the weighted "
                        "sum (zscore recommended: logit scales differ "
                        "across models)")
    p.add_argument("--fuse-out", default=None,
                   help="write fused 'utt_id score' lines here")
    args = p.parse_args(argv)

    fused_tabs = None
    if args.fuse:
        tabs = [read_scores(f) for f in [args.scores] + args.fuse]
        names = [args.scores] + args.fuse
        common_f = set(tabs[0]).intersection(*tabs[1:])
        if not common_f:
            # score files may mix full-path and bare-utterance keys
            norm = lambda k: k.rsplit("/", 1)[-1].rsplit(".", 1)[0]
            tabs = [{norm(k): v for k, v in t.items()} for t in tabs]
            common_f = set(tabs[0]).intersection(*tabs[1:])
        if not common_f:
            print("ERROR: no trials common to all fused score files",
                  file=sys.stderr)
            return 2
        w = args.fuse_weights or [1.0] * len(tabs)
        if len(w) != len(tabs):
            p.error(f"--fuse-weights needs {len(tabs)} weights "
                    f"(got {len(w)})")
        order = sorted(common_f)
        acc = np.zeros(len(order))
        for wi, t in zip(w, tabs):
            v = np.asarray([t[u] for u in order], np.float64)
            if args.fuse_norm == "zscore":
                v = (v - v.mean()) / max(float(v.std()), 1e-12)
            acc += wi * v
        fused = dict(zip(order, acc.tolist()))
        dropped = max(len(t) for t in tabs) - len(order)
        print(f"fused {len(tabs)} systems over {len(order)} common "
              f"trials ({dropped} dropped; norm={args.fuse_norm}, "
              f"weights={list(w)})")
        if args.fuse_out:
            with open(args.fuse_out, "w") as f:
                for u in order:
                    f.write(f"{u} {fused[u]}\n")
            print(f"wrote fused scores -> {args.fuse_out}")
        if not (args.protocol or (args.config and args.track)):
            return 0  # fusion-only mode (e.g. building a submission)
        fused_tabs = (tabs, names, fused)

    protocol = args.protocol
    if protocol is None:
        if not (args.config and args.track):
            p.error("need --protocol or (--config + --track)")
        from rtdsd_tpu_torch.config import load_yaml_config

        sys_cfg, _ = load_yaml_config(args.config)
        protocol = getattr(sys_cfg, TRACK_PROTOCOL_ATTR[args.track])
        if args.track == "InTheWild" and not protocol:
            protocol = sys_cfg.path_label_itw_eval

    ff, lf = args.file_field, args.label_field
    if ff is None or lf is None:
        if args.track is None:
            p.error("need --track or explicit --file-field/--label-field")
        ff, lf = TRACK_FIELDS[args.track]

    scores = (fused_tabs[2] if fused_tabs
              else read_scores(args.scores))
    labels = labels_from_protocol(protocol, ff, lf)
    normalized = False
    if not set(scores) & set(labels):
        # normalize BOTH sides to basename-sans-extension: score files may
        # key on full paths (ASVspoof5 matches the reference's path ids)
        # while protocols key on bare names, or vice versa
        norm = lambda k: k.rsplit("/", 1)[-1].rsplit(".", 1)[0]
        scores = {norm(k): v for k, v in scores.items()}
        labels = {norm(k): v for k, v in labels.items()}
        normalized = True
    common = sorted(set(scores) & set(labels))
    if not common:
        print("ERROR: no utterances in common between scores and protocol",
              file=sys.stderr)
        return 2
    s = np.asarray([scores[u] for u in common])
    y = np.asarray([labels[u] for u in common])
    n_bona = int(y.sum())
    eer = compute_eer(s, y, pos_label=1)
    print(f"trials: {len(common)} (bonafide {n_bona}, spoof "
          f"{len(common) - n_bona}; {len(scores) - len(common)} scores "
          f"unmatched)")
    if fused_tabs:
        tabs, names, _ = fused_tabs
        if normalized:
            norm = lambda k: k.rsplit("/", 1)[-1].rsplit(".", 1)[0]
            tabs = [{norm(k): v for k, v in t.items()} for t in tabs]
        for nm, t in zip(names, tabs):
            sv = np.asarray([t[u] for u in common])
            print(f"  system {nm}: EER {compute_eer(sv, y):.4f} %")
        print(f"fused EER: {eer:.4f} %")
    else:
        print(f"EER: {eer:.4f} %")
    if args.cascade_sweep:
        flag = read_scores(args.cascade_sweep)
        if normalized:  # same key normalization as the screener file
            norm = lambda k: k.rsplit("/", 1)[-1].rsplit(".", 1)[0]
            flag = {norm(k): v for k, v in flag.items()}
        missing = [u for u in common if u not in flag]
        if missing:
            print(f"ERROR: {len(missing)} trials missing from "
                  f"{args.cascade_sweep}", file=sys.stderr)
            return 2
        f = np.asarray([flag[u] for u in common])
        f_eer = compute_eer(f, y, pos_label=1)
        print(f"flagship EER: {f_eer:.4f} %  (screener EER above)")
        print("band  escalated  cascade EER%")
        dev = np.abs(s - args.cascade_center)
        for q in (0.0, 0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9, 1.0):
            band = float(np.quantile(dev, q)) if q > 0 else 0.0
            esc = dev <= band
            merged = np.where(esc, f, s)
            c_eer = compute_eer(merged, y, pos_label=1)
            print(f"{band:7.3f}  {esc.mean() * 100:6.1f} %  {c_eer:.4f}")
        if args.cascade_out:
            import json

            # dense sweep for the pick (the table above is for eyes)
            qs = np.arange(0.0, 1.0001, 0.02)
            cands = []
            for q in qs:
                band = float(np.quantile(dev, q)) if q > 0 else 0.0
                esc = dev <= band
                c = compute_eer(np.where(esc, f, s), y, pos_label=1)
                cands.append((band, float(esc.mean()), c))
            if args.cascade_pick_esc is not None:
                pick = min(cands, key=lambda t:
                           abs(t[1] - args.cascade_pick_esc))
            else:
                # smallest band (= cheapest escalation) whose cascade EER
                # is within the relative tolerance of the best achieved
                best = min(c for _b, _r, c in cands)
                tol = best * (1.0 + args.cascade_pick_tol) + 1e-12
                pick = next(t for t in cands if t[2] <= tol)
            band, rate, c_eer = pick
            side = {"kind": "cascade_calibration",
                    "band": band, "center": args.cascade_center,
                    "escalation_rate": rate,
                    "screener_eer": float(eer),
                    "flagship_eer": float(f_eer),
                    "cascade_eer": float(c_eer),
                    "n_trials": int(len(common)),
                    "screener_scores": os.path.basename(args.scores),
                    "flagship_scores": os.path.basename(
                        args.cascade_sweep)}
            with open(args.cascade_out, "w") as fh:
                json.dump(side, fh, indent=1)
            print(f"picked band {band:.4f} (escalates {rate * 100:.1f}%, "
                  f"cascade EER {c_eer:.4f}%) -> {args.cascade_out}")
    if args.calibrate:
        import json

        from rtdsd_tpu_torch.utils.metrics import calibrate_scores

        cal = calibrate_scores(s, y, target_fars=tuple(args.target_far),
                               target_frrs=tuple(args.target_frr))
        # JSON keys must be strings; keep the rate as the printed key
        cal["at_far"] = {f"{k:g}": v for k, v in cal["at_far"].items()}
        cal["at_frr"] = {f"{k:g}": v for k, v in cal["at_frr"].items()}
        print(json.dumps(cal))
    if args.tdcf:
        from rtdsd_tpu_torch.utils.metrics import compute_min_tdcf

        tdcf = compute_min_tdcf(s, y, pmiss_asv=args.pmiss_asv,
                                pfa_asv=args.pfa_asv,
                                pmiss_spoof_asv=args.pmiss_spoof_asv)
        print(f"min t-DCF: {tdcf:.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
