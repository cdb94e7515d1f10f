"""Standalone evaluation entry point (the serving path).

Counterpart of ``backtoreality_tpu/train/evaluate.py``: load a
checkpoint, run the detector forward over a split, decode and NMS the
boxes, print per-class AP/AR at the requested IoU thresholds, over
``--eval_seeds`` point-subsample seeds. ``--model votenet`` takes the
VoteNet flags and ``--kind``; ``--model groupfree`` takes GroupFree3D's
(``train/groupfree.py``), scores the last decoder layer's head (``last_``,
or ``proposal_`` without a decoder) at ``--ap_iou_thresholds`` with a
confidence threshold of 0.0. It runs on the CUDA card unless ``--device
cpu`` is given, and raises if no card is present and the CPU was not
asked for.

Checkpoints are the JAX package's msgpack checkpoints (gzipped or not),
``torch.save`` files of the port's ``state_dict``, or the training
checkpoints of ``train/votenet.py``; ``common.load_weights`` tells them
apart. A checkpoint must cover every entry of the graph asked for:
one trained with another graph is refused rather than scored with
fresh weights. A checkpoint of the reference implementation is converted
first by ``tools.torch_import`` (one passed as it is is refused, with that
command) and scored with ``--query_mode exact``, the reference's first-k
grouping it was trained with.

``--bf16`` computes in bfloat16 over the float32 parameters (``--f32_tail
N``: the backbone's last N stages in float32). Before scoring, the BN
running statistics are recalibrated over ``--bn_recal_batches``
train-mode batches (default 20 with ``--bf16``, else none) of
``--train_data_root``'s ``--recal_split``, shuffled and augmented, as the
training loops do before each evaluation: without a train root an
implied recalibration is skipped with a warning, an explicit one exits.

Usage:
  python -m backtoreality_tpu_torch.train.evaluate --model votenet \
      --checkpoint_path log/checkpoint.pt --data_root data [...]
  python -m backtoreality_tpu_torch.train.evaluate --model groupfree \
      --checkpoint_path log_gf/ckpt_epoch_last.tar --data_root data [...]
  python -m backtoreality_tpu_torch.train.evaluate --model votenet \
      --checkpoint_path imported.pt --query_mode exact --data_root data
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.dataset import DetectionDataset
from backtoreality_tpu_torch.data.loader import DetectionDataLoader
from backtoreality_tpu_torch.eval import (
    APCalculator,
    parse_groundtruths,
    parse_predictions,
)
from backtoreality_tpu_torch.models.votenet import (VoteNet, VoteNetDA,
                                                    VoteNetDAJitter)
from backtoreality_tpu_torch.train import common, groupfree
from backtoreality_tpu_torch.train.common import resolve_device

# model-output keys needed by host-side eval
EVAL_KEYS = (
    "center", "heading_scores", "heading_residuals", "size_scores",
    "size_residuals", "sem_cls_scores", "objectness_scores",
)

EVAL_CONFIG_DICT = dict(
    remove_empty_box=False, use_3d_nms=True, nms_iou=0.25,
    use_old_type_nms=False, cls_nms=True, per_class_proposal=True,
    conf_thresh=0.05,
)


def add_common_flags(parser: argparse.ArgumentParser):
    """The VoteNet flags that evaluation reads, with the JAX package's
    names and defaults; choices list what is ported."""
    parser.add_argument("--dataset", default="scannet_md40",
                        choices=["scannet_md40", "matterport_md40"])
    parser.add_argument("--data_root", default="data",
                        help="directory containing the *_detection_data"
                             " exports (synthetic fixtures accepted)")
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--num_point", type=int, default=40000)
    parser.add_argument("--num_target", type=int, default=256)
    parser.add_argument("--vote_factor", type=int, default=1)
    parser.add_argument("--cluster_sampling", default="vote_fps",
                        choices=["vote_fps", "seed_fps"])
    parser.add_argument("--ap_iou_thresh", type=float, default=0.25)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--no_height", action="store_true")
    parser.add_argument("--use_color", action="store_true")
    parser.add_argument("--query_mode", default="stratified",
                        choices=["stratified", "exact"],
                        help="exact: the reference's first-k neighbours"
                             " in index order, which reference-trained"
                             " checkpoints expect")
    parser.add_argument("--fps_candidates", type=int, default=None,
                        help="subset-FPS at SA1: sample from the first"
                             " K (pre-shuffled) points")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 model compute (f32 params/stats)")
    parser.add_argument("--f32_tail", type=int, default=0,
                        help="with --bf16: run the last N backbone"
                             " stages (fp2, fp1, sa4, ...) in f32."
                             " These stages carry <2%% of the HBM"
                             " traffic but feed the classification"
                             " heads, where bf16's quality deficit"
                             " concentrates")
    parser.add_argument("--bn_recal_batches", type=int, default=None,
                        help="train-mode batches to refresh BN running"
                             " stats before each eval (default 20 with"
                             " --bf16, else 0): bf16 weight drift after"
                             " the BN-momentum floor staleness-shifts"
                             " frozen stats")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; pass cpu to run"
                             " on the CPU)")
    return parser


def _input_dim(flags) -> int:
    return int(not flags.no_height) + 3 * int(flags.use_color)


MODELS = {"plain": VoteNet, "da": VoteNetDA, "da_jitter": VoteNetDAJitter}


def build_model(flags, cfg, kind: str = "plain") -> VoteNet:
    """The VoteNet graph `kind` (plain, da or da_jitter) at `flags`."""
    return MODELS[kind](
        num_class=cfg.num_class,
        num_heading_bin=cfg.num_heading_bin,
        num_size_cluster=cfg.num_size_cluster,
        mean_size_arr=cfg.mean_size_arr,
        input_feature_dim=_input_dim(flags),
        num_proposal=flags.num_target,
        vote_factor=flags.vote_factor,
        sampling=flags.cluster_sampling,
        query_mode=flags.query_mode,
        fps_candidates=flags.fps_candidates,
        dtype=common.compute_dtype(flags),
        f32_tail=flags.f32_tail)


def _recalibrate(model, flags, cfg, device, use_height, jitter, gf):
    """BN recalibration before scoring, with the JAX package's semantics
    (`backtoreality_tpu/train/evaluate.py:132-200`)."""
    num_batches = common.recal_batches(flags)
    if num_batches <= 0:
        return
    if not flags.train_data_root:
        if flags.bn_recal_batches is not None:
            raise SystemExit(
                "--bn_recal_batches > 0 requires --train_data_root"
                " (recalibration draws train-mode batches)")
        print("warning: BN recalibration implied by --bf16 but no"
              " --train_data_root given; evaluating with the"
              " checkpoint's frozen BN stats")
        return
    recal_ds = DetectionDataset(
        cfg, flags.train_data_root, split=flags.recal_split,
        num_points=flags.num_point, use_color=flags.use_color,
        use_height=use_height, augment=True, gf_labels=gf)
    recal_loader = DetectionDataLoader(recal_ds, flags.batch_size,
                                       shuffle=True, drop_last=True)
    if len(recal_loader) == 0:
        # drop_last with fewer scans than a batch: nothing to draw
        raise SystemExit(
            f"BN recalibration loader is empty: {flags.train_data_root}"
            f" split={flags.recal_split} has {len(recal_ds)} scans"
            f" < batch_size {flags.batch_size}")
    with contextlib.ExitStack() as stack:
        before = (stack.enter_context(groupfree.recal_dropout(model))
                  if gf else None)
        step = common.make_recal_step(model, jitter=jitter, before=before)
        done = common.recalibrate_bn(recal_loader, step, device,
                                     num_batches)
    print(f"recalibrated BN stats over {done} train batches")


def _print_metrics(name, t, runs):
    """The JAX package's print: one seed's metrics, or each key's mean
    +/- sigma (with the seeds' values for mAP and AR)."""
    print(f"===== {name} @ IoU {t} =====")
    if len(runs) == 1:
        for key in sorted(runs[0]):
            print(f"  {key}: {runs[0][key]:.4f}")
        return
    for key in ("mAP", "AR"):
        vals = np.asarray([r[key] for r in runs])
        draws = " ".join(f"{v:.4f}" for v in vals)
        print(f"  {key}: {vals.mean():.4f} +/- {vals.std(ddof=1):.4f}"
              f"  (seeds: {draws})")
    for key in sorted(runs[0]):
        if key not in ("mAP", "AR"):
            vals = np.asarray([r[key] for r in runs])
            print(f"  {key}: {vals.mean():.4f} +/- {vals.std(ddof=1):.4f}")


def main(argv=None):
    """Returns {(prefix, iou_threshold): metrics}: each key's mean over
    the seeds, and under "seeds" every seed's metrics dict. The prefix is
    "" for VoteNet, the scored head's (``last_`` or ``proposal_``) for
    GroupFree3D."""
    common.make_deterministic()
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=["votenet", "groupfree"],
                        default="votenet")
    parser.add_argument("--eval_seeds", type=int, default=1,
                        help="repeat the eval under N different"
                             " point-subsample seeds and report"
                             " mean +/- sigma")
    if argv is None:
        import sys

        argv = sys.argv[1:]
    pre, rest = parser.parse_known_args(argv)

    sub = argparse.ArgumentParser()
    if pre.model == "votenet":
        add_common_flags(sub)
        sub.add_argument("--kind", default="plain", choices=sorted(MODELS),
                         help="model graph the checkpoint was trained with"
                              " (BR -> da, CenterRefine -> da_jitter)")
    else:
        groupfree.add_flags(sub)
    sub.add_argument("--split", default="val")
    sub.add_argument("--train_data_root", default=None,
                     help="train split for BN recalibration"
                          " (--bn_recal_batches; required for faithful"
                          " --bf16 checkpoint eval: the training loops"
                          " recalibrate stale BN stats before every"
                          " in-loop eval)")
    sub.add_argument("--recal_split", default="all")
    flags = sub.parse_args(rest)
    if not flags.checkpoint_path:
        raise SystemExit("--checkpoint_path is required")
    device = resolve_device(flags.device)
    cfg = get_config(flags.dataset)
    if pre.model == "votenet":
        model = build_model(flags, cfg, flags.kind)
        graph, jitter = f"--kind {flags.kind}", flags.kind == "da_jitter"
        use_height = not flags.no_height
        thresholds, prefixes = [flags.ap_iou_thresh, 0.5], ("",)
        conf_thresh = EVAL_CONFIG_DICT["conf_thresh"]
    else:
        model = groupfree.build_model(flags, cfg)
        graph, jitter = "--model groupfree", False
        use_height = flags.use_height
        thresholds = flags.ap_iou_thresholds
        prefixes = groupfree.eval_prefixes(flags)
        conf_thresh = groupfree.GF_EVAL_CONFIG_DICT["conf_thresh"]
    # a leaf left at its fresh init would be scored as if trained
    common.restore_weights(model, flags.checkpoint_path, graph, log=print)
    model.to(device)
    _recalibrate(model, flags, cfg, device, use_height, jitter,
                 pre.model == "groupfree")
    model.eval()

    ds = DetectionDataset(
        cfg, flags.data_root, split=flags.split, num_points=flags.num_point,
        use_color=flags.use_color, use_height=use_height, augment=False,
        gf_labels=pre.model == "groupfree")
    loader = DetectionDataLoader(ds, flags.batch_size, shuffle=False,
                                 drop_last=False)
    print(f"eval scans: {len(ds)}")

    keys = [p + k for p in prefixes for k in EVAL_KEYS]
    config_dict = dict(EVAL_CONFIG_DICT, conf_thresh=conf_thresh,
                       dataset_config=cfg)
    history = {(p, t): [] for p in prefixes for t in thresholds}
    base_seed = ds.seed
    for si in range(max(1, pre.eval_seeds)):
        # a different dataset seed redraws every scan's point subsample
        # (and nothing else: augment=False)
        ds.seed = base_seed + si
        calcs = {key: APCalculator(key[1], cfg.class2type)
                 for key in history}
        with torch.inference_mode():
            for batch in loader:
                end_points = model(*(torch.from_numpy(a).to(device)
                                     for a in common.model_args(batch,
                                                               jitter)))
                outs = {k: end_points[k].cpu().numpy() for k in keys}
                gts = parse_groundtruths(batch, config_dict)
                for prefix in prefixes:
                    preds = parse_predictions(outs, config_dict, prefix)
                    for t in thresholds:
                        calcs[(prefix, t)].step(preds, gts)
        for key, calc in calcs.items():
            history[key].append(calc.compute_metrics())

    results = {}
    for (prefix, t), runs in history.items():
        _print_metrics(prefix or "votenet", t, runs)
        mean = {k: float(np.mean([r[k] for r in runs])) for k in runs[0]}
        results[(prefix, t)] = dict(mean, seeds=runs)
    return results


if __name__ == "__main__":
    main()
