"""Matched-epoch comparison of a reference-loop run vs our trainer.

Counterpart of ``backtoreality_tpu/tools/parity_report.py``, copied
with the same code (its text says "trainer" for a training script);
the port's trainers write the same `metrics.jsonl` rows.

Reads the torch reference loop's `history.jsonl` (tools/ref_loop.py,
one row per epoch: {"epoch", "loss", ...} plus {"mAP", "AR",
"eval_loss"} on eval epochs) and our trainer's `metrics.jsonl`
(train/observability.ScalarHistory: per-epoch rows keyed "step" plus
{"kind": "eval"} rows), and prints the matched-epoch train-loss and
mAP/AR table that the system-parity evidence section is built from
(reference loop semantics: `train_Votenet_FSB.py:211-292`).

Usage:
  python -m backtoreality_tpu_torch.tools.parity_report \
      --ref_dir /tmp/parity_ref --ours_dir /tmp/parity_ours [--json]
"""

from __future__ import annotations

import argparse
import json
import pathlib


def _load_jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]


# preferred per-term component ordering (VoteNet keys); any other
# shared *_loss keys (e.g. GF's per-prefix heads) are appended sorted.
# Both systems log under the reference's key names (our ScalarHistory
# mirrors `train_Votenet_FSB.py:233-243`; ref_loop.py records the same
# stat_dict per epoch).
COMPONENTS = (
    "vote_loss", "objectness_loss", "center_loss", "heading_cls_loss",
    "heading_reg_loss", "size_cls_loss", "size_reg_loss",
    "sem_cls_loss", "box_loss",
)


def _component_keys(ref_row: dict, ours_row: dict) -> list[str]:
    """Shared per-component keys. A ref key `X_loss` also matches our
    `X_loss_S`: the DA/CR reference loops accumulate the SOURCE-domain
    end_points (ref_loop.py `_accumulate_batch(stat_sums, ep_S, ...)`),
    while our DA trainers log both domains with _S/_T suffixes."""
    shared = [k for k in ref_row
              if k.endswith("_loss") and k != "eval_loss"
              and (k in ours_row or k + "_S" in ours_row)]
    ordered = [k for k in COMPONENTS if k in shared]
    return ordered + sorted(k for k in shared if k not in COMPONENTS)


def _ours_component(ours_row: dict, key: str):
    return ours_row[key] if key in ours_row else ours_row[key + "_S"]


def build_report(ref_dir: str, ours_dir: str,
                 ref_loss_scale: float = 1.0) -> dict:
    """`ref_loss_scale` rescales the ref history's total 'loss' only
    (components are untouched): ref_loop runs recorded before
    2026-08-18 by the cr/groupfree recipes double-counted the logged
    total (see ref_loop._accumulate_batch) — pass 0.5 for those."""
    ref = _load_jsonl(pathlib.Path(ref_dir) / "history.jsonl")
    ours = _load_jsonl(pathlib.Path(ours_dir) / "metrics.jsonl")

    ref_loss = {r["epoch"]: r["loss"] * ref_loss_scale
                for r in ref if "loss" in r}
    ref_eval = {r["epoch"]: (r["mAP"], r["AR"]) for r in ref
                if "mAP" in r}
    ref_rows = {r["epoch"]: r for r in ref if "loss" in r}
    ours_loss = {r["step"]: r["loss"] for r in ours
                 if r.get("kind") is None and "loss" in r}
    ours_rows = {r["step"]: r for r in ours
                 if r.get("kind") is None and "loss" in r}
    ours_eval = {r["step"]: (r["mAP"], r["AR"]) for r in ours
                 if r.get("kind") == "eval"}

    epochs = sorted(set(ref_loss) & set(ours_loss))
    rows = [{"epoch": e, "ours_loss": ours_loss[e],
             "ref_loss": ref_loss[e]} for e in epochs]
    eval_rows = [{"epoch": e,
                  "ours_mAP": ours_eval[e][0], "ref_mAP": ref_eval[e][0],
                  "ours_AR": ours_eval[e][1], "ref_AR": ref_eval[e][1]}
                 for e in sorted(set(ref_eval) & set(ours_eval))]
    # per-component ours/ref ratios at matched epochs (only where the
    # ref history carries components — older ref_loop logs total only)
    comp_rows = []
    for e in epochs:
        rr, orow = ref_rows[e], ours_rows[e]
        comps = {c: (_ours_component(orow, c), rr[c])
                 for c in _component_keys(rr, orow) if rr[c]}
        if comps:
            comp_rows.append({"epoch": e, **{
                c: round(o / r, 3) for c, (o, r) in comps.items()}})
    return {"loss": rows, "eval": eval_rows, "components": comp_rows}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ref_dir", required=True)
    parser.add_argument("--ours_dir", required=True)
    parser.add_argument("--every", type=int, default=5,
                        help="print every Nth epoch's loss row")
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--ref_loss_scale", type=float, default=1.0,
                        help="rescale the ref total loss (0.5 for "
                             "cr/groupfree ref_loop histories recorded "
                             "before 2026-08-18, which double-counted "
                             "the logged total)")
    args = parser.parse_args(argv)

    report = build_report(args.ref_dir, args.ours_dir,
                          ref_loss_scale=args.ref_loss_scale)
    if args.json:
        print(json.dumps(report))
        return report

    print(f"{'epoch':>6} {'ours loss':>10} {'ref loss':>10} {'ratio':>7}")
    for row in report["loss"]:
        if row["epoch"] % args.every and row != report["loss"][-1]:
            continue
        ratio = row["ours_loss"] / row["ref_loss"]
        print(f"{row['epoch']:>6} {row['ours_loss']:>10.3f} "
              f"{row['ref_loss']:>10.3f} {ratio:>7.3f}")
    if report["eval"]:
        print(f"\n{'epoch':>6} {'ours mAP':>9} {'ref mAP':>9} "
              f"{'ours AR':>9} {'ref AR':>9}")
        for row in report["eval"]:
            print(f"{row['epoch']:>6} {row['ours_mAP']:>9.4f} "
                  f"{row['ref_mAP']:>9.4f} {row['ours_AR']:>9.4f} "
                  f"{row['ref_AR']:>9.4f}")
    if report["components"]:
        # columns: every component key any row carries, in the
        # canonical order first (VoteNet keys) then sorted (e.g. GF's
        # per-prefix head keys)
        seen: dict[str, None] = {}
        for row in report["components"]:
            for c in row:
                if c != "epoch":
                    seen[c] = None
        comps = ([c for c in COMPONENTS if c in seen]
                 + sorted(c for c in seen if c not in COMPONENTS))
        print("\nours/ref per-component ratio:")
        print(f"{'epoch':>6} " + " ".join(
            f"{c.replace('_loss', ''):>11}" for c in comps))
        for row in report["components"]:
            if row["epoch"] % args.every and row != report["components"][-1]:
                continue
            print(f"{row['epoch']:>6} " + " ".join(
                f"{row.get(c, float('nan')):>11.3f}" for c in comps))
    return report


if __name__ == "__main__":
    main()
