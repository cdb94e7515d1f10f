"""Standalone evaluation entry point (the serving path).

Counterpart of ``backtoreality_tpu/train/evaluate.py`` for
``--model votenet``: load a checkpoint, run the detector forward over a
split, decode and NMS the boxes, print per-class AP/AR at the requested
IoU thresholds, over ``--eval_seeds`` point-subsample seeds. It runs on
the CUDA card unless ``--device cpu`` is given, and raises if no card is
present and the CPU was not asked for.

Checkpoints are the JAX package's msgpack checkpoints (gzipped or not),
``torch.save`` files of the port's ``state_dict``, or the training
checkpoints of ``train/votenet.py``; ``common.load_weights`` tells them
apart. A checkpoint must cover every entry of the ``--kind`` graph:
one trained with another graph is refused rather than scored with
fresh weights. Not ported yet: BN recalibration, GroupFree3D and
``--bf16``.

Usage:
  python -m backtoreality_tpu_torch.train.evaluate --model votenet \
      --checkpoint_path log/checkpoint.pt --data_root data [...]
"""

from __future__ import annotations

import argparse

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
from backtoreality_tpu_torch.train import common

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
                        choices=["stratified"])
    parser.add_argument("--fps_candidates", type=int, default=None,
                        help="subset-FPS at SA1: sample from the first"
                             " K (pre-shuffled) points")
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
        fps_candidates=flags.fps_candidates)


def model_args(batch, jitter: bool) -> tuple:
    """The model's inputs from a batch: the point clouds, and for the
    jitter model also the centre and class labels."""
    if jitter:
        return (batch["point_clouds"], batch["center_label"],
                batch["sem_cls_label"])
    return (batch["point_clouds"],)


def resolve_device(name: str | None) -> torch.device:
    """`name`, or cuda when None. Raises when cuda is asked for (or
    implied) and no card is present: never falls back to the CPU."""
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass"
                               " --device cpu to run on the CPU")
        # the JAX geometry and matmuls run at full f32 precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


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
    the seeds, and under "seeds" every seed's metrics dict."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=["votenet"], default="votenet")
    parser.add_argument("--eval_seeds", type=int, default=1,
                        help="repeat the eval under N different"
                             " point-subsample seeds and report"
                             " mean +/- sigma")
    if argv is None:
        import sys

        argv = sys.argv[1:]
    pre, rest = parser.parse_known_args(argv)

    sub = add_common_flags(argparse.ArgumentParser())
    sub.add_argument("--split", default="val")
    sub.add_argument("--kind", default="plain", choices=sorted(MODELS),
                     help="model graph the checkpoint was trained with"
                          " (BR -> da, CenterRefine -> da_jitter)")
    flags = sub.parse_args(rest)
    if not flags.checkpoint_path:
        raise SystemExit("--checkpoint_path is required")
    device = resolve_device(flags.device)
    cfg = get_config(flags.dataset)

    model = build_model(flags, cfg, flags.kind)
    state, epoch = common.load_weights(flags.checkpoint_path)
    if common.partial_restore(model, state, log=print):
        # a leaf left at its fresh init would be scored as if trained
        raise SystemExit(
            f"{flags.checkpoint_path} does not cover the --kind"
            f" {flags.kind} model: it was trained with another graph")
    print(f"loaded checkpoint {flags.checkpoint_path}"
          + ("" if epoch is None else f" from epoch {epoch}"))
    model.to(device).eval()

    ds = DetectionDataset(
        cfg, flags.data_root, split=flags.split, num_points=flags.num_point,
        use_color=flags.use_color, use_height=not flags.no_height,
        augment=False)
    loader = DetectionDataLoader(ds, flags.batch_size, shuffle=False,
                                 drop_last=False)
    print(f"eval scans: {len(ds)}")

    jitter = flags.kind == "da_jitter"
    thresholds = [flags.ap_iou_thresh, 0.5]
    config_dict = dict(EVAL_CONFIG_DICT, dataset_config=cfg)
    history = {t: [] for t in thresholds}
    base_seed = ds.seed
    for si in range(max(1, pre.eval_seeds)):
        # a different dataset seed redraws every scan's point subsample
        # (and nothing else: augment=False)
        ds.seed = base_seed + si
        calcs = {t: APCalculator(t, cfg.class2type) for t in thresholds}
        with torch.inference_mode():
            for batch in loader:
                end_points = model(*(torch.from_numpy(a).to(device)
                                     for a in model_args(batch, jitter)))
                outs = {k: end_points[k].cpu().numpy() for k in EVAL_KEYS}
                preds = parse_predictions(outs, config_dict)
                gts = parse_groundtruths(batch, config_dict)
                for calc in calcs.values():
                    calc.step(preds, gts)
        for t, calc in calcs.items():
            history[t].append(calc.compute_metrics())

    results = {}
    for t, runs in history.items():
        _print_metrics("votenet", t, runs)
        mean = {k: float(np.mean([r[k] for r in runs])) for k in runs[0]}
        results[("", t)] = dict(mean, seeds=runs)
    return results


if __name__ == "__main__":
    main()
