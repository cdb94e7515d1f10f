"""Standalone evaluation entry point (the serving path).

Counterpart of ``backtoreality_tpu/train/evaluate.py`` for
``--model votenet --kind plain``: load a checkpoint, run the detector
forward over a split, decode and NMS the boxes, print per-class AP/AR at
the requested IoU thresholds. It runs on the CUDA card unless
``--device cpu`` is given, and raises if no card is present and the CPU
was not asked for.

Checkpoints are ``torch.save`` files of the port's ``state_dict``
(``bridge.state_dict_from_jax`` converts the JAX package's variables).
Not ported yet: BN recalibration, ``--eval_seeds > 1``, the ``da`` and
``da_jitter`` kinds, GroupFree3D and ``--bf16``.

Usage:
  python -m backtoreality_tpu_torch.train.evaluate --model votenet \
      --checkpoint_path log/checkpoint.pt --data_root data [...]
"""

from __future__ import annotations

import argparse

import torch

from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.dataset import DetectionDataset
from backtoreality_tpu_torch.data.loader import DetectionDataLoader
from backtoreality_tpu_torch.eval import (
    APCalculator,
    parse_groundtruths,
    parse_predictions,
)
from backtoreality_tpu_torch.models.votenet import VoteNet

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
                        choices=["vote_fps"])
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


def build_model(flags, cfg) -> VoteNet:
    return VoteNet(
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


def main(argv=None):
    """Returns {(prefix, iou_threshold): metrics dict}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=["votenet"], default="votenet")
    parser.add_argument("--eval_seeds", type=int, default=1,
                        help="only 1 is ported")
    if argv is None:
        import sys

        argv = sys.argv[1:]
    pre, rest = parser.parse_known_args(argv)
    if pre.eval_seeds != 1:
        raise SystemExit("--eval_seeds > 1 is not ported")

    sub = add_common_flags(argparse.ArgumentParser())
    sub.add_argument("--split", default="val")
    sub.add_argument("--kind", default="plain", choices=["plain"])
    flags = sub.parse_args(rest)
    if not flags.checkpoint_path:
        raise SystemExit("--checkpoint_path is required")
    device = resolve_device(flags.device)
    cfg = get_config(flags.dataset)

    model = build_model(flags, cfg)
    state = torch.load(flags.checkpoint_path, map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state)
    model.to(device).eval()
    print(f"loaded checkpoint {flags.checkpoint_path}")

    ds = DetectionDataset(
        cfg, flags.data_root, split=flags.split, num_points=flags.num_point,
        use_color=flags.use_color, use_height=not flags.no_height,
        augment=False)
    loader = DetectionDataLoader(ds, flags.batch_size, shuffle=False,
                                 drop_last=False)
    print(f"eval scans: {len(ds)}")

    thresholds = [flags.ap_iou_thresh, 0.5]
    config_dict = dict(EVAL_CONFIG_DICT, dataset_config=cfg)
    calcs = {t: APCalculator(t, cfg.class2type) for t in thresholds}
    with torch.inference_mode():
        for batch in loader:
            pc = torch.from_numpy(batch["point_clouds"]).to(device)
            end_points = model(pc)
            outs = {k: end_points[k].cpu().numpy() for k in EVAL_KEYS}
            preds = parse_predictions(outs, config_dict)
            gts = parse_groundtruths(batch, config_dict)
            for calc in calcs.values():
                calc.step(preds, gts)

    results = {}
    for t, calc in calcs.items():
        metrics = calc.compute_metrics()
        results[("", t)] = metrics
        print(f"===== votenet @ IoU {t} =====")
        for key in sorted(metrics):
            print(f"  {key}: {metrics[key]:.4f}")
    return results


if __name__ == "__main__":
    main()
