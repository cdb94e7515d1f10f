"""VoteNet training loop, the FSB recipe.

Counterpart of the FSB path of ``backtoreality_tpu/train/votenet.py``
(reference `train_Votenet_FSB.py`): one train step (train-mode forward,
`losses/votenet.get_loss`, backward, Adam), host-side learning-rate and
BN-momentum schedules set before each epoch, a checkpoint of model and
optimizer after each epoch, and the reference evaluation protocol every
`eval_freq` epochs. It runs on the CUDA card unless ``--device cpu`` is
given, and raises if no card is present and the CPU was not asked for.

Flag names and defaults are the JAX package's. Not ported, and so
refused by the parser: ``--multihost``, ``--num_devices``, ``--bf16``,
``--f32_tail``, ``--bn_recal_batches``, ``--profile_dir``,
``--guard_every_steps`` and ``--ram_cache_gb`` (the dataset keeps its
default RAM cache of 8 GiB); the WSB, BR and CenterRefine recipes.

Usage:
  python -m backtoreality_tpu_torch.train.votenet_fsb --data_root D \
      [--log_dir log_votenet] [--device cpu] [...]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.dataset import DetectionDataset
from backtoreality_tpu_torch.data.loader import DetectionDataLoader
from backtoreality_tpu_torch.eval import (APCalculator, parse_groundtruths,
                                          parse_predictions)
from backtoreality_tpu_torch.losses import votenet as vote_losses
from backtoreality_tpu_torch.nn import set_bn_momentum
from backtoreality_tpu_torch.train import common
from backtoreality_tpu_torch.train.evaluate import (EVAL_CONFIG_DICT,
                                                    EVAL_KEYS, build_model,
                                                    resolve_device)
from backtoreality_tpu_torch.train.observability import ScalarHistory

__all__ = ["add_common_flags", "build_model", "make_train_step",
           "make_eval_step", "evaluate", "main"]


def add_common_flags(parser: argparse.ArgumentParser):
    parser.add_argument("--dataset", default="scannet_md40",
                        choices=["scannet_md40", "matterport_md40"])
    parser.add_argument("--data_root", default="data",
                        help="directory containing the *_detection_data"
                             " exports (synthetic fixtures accepted)")
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--log_dir", default="log_votenet")
    parser.add_argument("--num_point", type=int, default=40000)
    parser.add_argument("--num_target", type=int, default=256)
    parser.add_argument("--vote_factor", type=int, default=1)
    parser.add_argument("--cluster_sampling", default="vote_fps",
                        choices=["vote_fps", "seed_fps"])
    parser.add_argument("--ap_iou_thresh", type=float, default=0.25)
    parser.add_argument("--max_epoch", type=int, default=180)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--bn_decay_step", type=int, default=20)
    parser.add_argument("--bn_decay_rate", type=float, default=0.5)
    parser.add_argument("--lr_decay_steps", default="80,120,160")
    parser.add_argument("--lr_decay_rates", default="0.1,0.1,0.1")
    parser.add_argument("--no_height", action="store_true")
    parser.add_argument("--use_color", action="store_true")
    parser.add_argument("--eval_freq", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--query_mode", default="stratified",
                        choices=["stratified"])
    parser.add_argument("--fps_candidates", type=int, default=None,
                        help="subset-FPS at SA1: sample from the first"
                             " K (pre-shuffled) points")
    parser.add_argument("--resume", action="store_true",
                        help="restore optimizer state + epoch from"
                             " --checkpoint_path and continue")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; pass cpu to run"
                             " on the CPU)")
    return parser


def to_device(batch: dict, device) -> dict:
    """Host batch (numpy arrays) -> tensors on `device`."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def _scalars(aux):
    return {k: v.detach() for k, v in aux.items() if v.dim() == 0}


def make_train_step(model, optimizer, criterion, cfg):
    """step(batch, bn_momentum) -> scalar aux tensors (on the device).

    One train-mode forward, the criterion, backward and an optimizer
    step; BN running statistics move with `bn_momentum`."""

    def step(batch, bn_momentum):
        model.train()
        set_bn_momentum(model, bn_momentum)
        end_points = model(batch["point_clouds"])
        loss, aux = criterion({**batch, **end_points}, cfg)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return _scalars(aux)

    return step


def make_eval_step(model, criterion, cfg):
    """step(batch) -> (predictions for EVAL_KEYS, scalar aux)."""

    def step(batch):
        model.eval()
        with torch.no_grad():
            outs = model(batch["point_clouds"])
            _, aux = criterion({**batch, **outs}, cfg)
        return {k: outs[k] for k in EVAL_KEYS}, _scalars(aux)

    return step


def evaluate(loader, eval_step, cfg, device, logger, ap_iou_thresh=0.25):
    """Eval loss means and mAP/AR at `ap_iou_thresh` over `loader`."""
    config_dict = dict(EVAL_CONFIG_DICT, dataset_config=cfg)
    calc = APCalculator(ap_iou_thresh, cfg.class2type)
    meter = common.MetricMeter()
    for batch in loader:
        pred, aux = eval_step(to_device(batch, device))
        meter.update({k: v.item() for k, v in aux.items()})
        pred_np = {k: v.cpu().numpy() for k, v in pred.items()}
        calc.step(parse_predictions(pred_np, config_dict),
                  parse_groundtruths(batch, config_dict))
    metrics = calc.compute_metrics()
    means = meter.means()
    if logger:
        logger.info("eval loss: %s",
                    {k: round(v, 4) for k, v in means.items()
                     if "loss" in k})
        logger.info("eval mAP@%.2f: %.4f  AR: %.4f", ap_iou_thresh,
                    metrics["mAP"], metrics["AR"])
    return metrics, means


def _train_loop_single(flags, recipe):
    """FSB (full labels). Returns the trained model and its optimizer."""
    if recipe != "fsb":
        raise ValueError(f"recipe {recipe!r} is not ported")
    device = resolve_device(flags.device)
    cfg = get_config(flags.dataset)
    logger = common.setup_logger(flags.log_dir)
    common.dump_config(flags.log_dir, vars(flags))

    train_ds = DetectionDataset(
        cfg, flags.data_root, split=flags.train_split,
        num_points=flags.num_point, use_color=flags.use_color,
        use_height=not flags.no_height, augment=True, seed=flags.seed)
    val_ds = DetectionDataset(
        cfg, flags.val_data_root or flags.data_root,
        split=flags.val_split, num_points=flags.num_point,
        use_color=flags.use_color, use_height=not flags.no_height,
        augment=False, seed=flags.seed)
    train_loader = DetectionDataLoader(train_ds, flags.batch_size,
                                       seed=flags.seed)
    val_loader = DetectionDataLoader(val_ds, flags.batch_size,
                                     shuffle=False, drop_last=False)
    logger.info("train scans: %d, val scans: %d", len(train_ds),
                len(val_ds))

    torch.manual_seed(flags.seed)
    model = build_model(flags, cfg).to(device)
    optimizer = common.make_optimizer(
        model.parameters(), "adam", flags.weight_decay,
        lr0=flags.learning_rate)
    criterion = vote_losses.get_loss

    start_epoch = 0
    if flags.checkpoint_path:
        ckpt = common.load_checkpoint(flags.checkpoint_path)
        model.load_state_dict(ckpt.get("model", ckpt))
        ckpt_epoch = ckpt.get("epoch", -1)
        if flags.resume:
            if "optimizer" not in ckpt:
                raise ValueError(f"--resume needs a training checkpoint;"
                                 f" {flags.checkpoint_path} holds weights"
                                 " only")
            optimizer.load_state_dict(ckpt["optimizer"])
            start_epoch = ckpt_epoch + 1
        logger.info("restored %s from %s (epoch %d)",
                    "full state" if flags.resume else "weights",
                    flags.checkpoint_path, ckpt_epoch)
    history = ScalarHistory(flags.log_dir)

    train_step = make_train_step(model, optimizer, criterion, cfg)
    eval_step = make_eval_step(model, criterion, cfg)
    lr_fn = common.step_lr(
        flags.learning_rate,
        [int(x) for x in flags.lr_decay_steps.split(",")],
        [float(x) for x in flags.lr_decay_rates.split(",")])
    bn_fn = common.bn_momentum_fn(step=flags.bn_decay_step,
                                  rate=flags.bn_decay_rate)

    ckpt_path = os.path.join(flags.log_dir, "checkpoint.tar")
    for epoch in range(start_epoch, flags.max_epoch):
        common.set_learning_rate(optimizer, lr_fn(epoch))
        bnm = bn_fn(epoch)
        train_loader.set_epoch(epoch)
        t0 = time.time()
        aux_hist = [train_step(to_device(batch, device), bnm)
                    for batch in train_loader]
        means = common.fetch_aux_means(aux_hist)  # waits for the device
        dt = time.time() - t0
        nb = len(aux_hist)
        logger.info(
            "epoch %03d lr %.2e bnm %.3f loss %.4f obj_acc %.3f "
            "(%d batches, %.1fs, %.2f scenes/s)",
            epoch, lr_fn(epoch), bnm, means.get("loss", float("nan")),
            means.get("obj_acc", float("nan")), nb, dt,
            nb * flags.batch_size / max(dt, 1e-9))
        history.append(epoch, means, lr=lr_fn(epoch),
                       scenes_per_sec=nb * flags.batch_size
                       / max(dt, 1e-9))
        common.save_checkpoint(ckpt_path, model, optimizer, epoch)
        if (epoch + 1) % flags.eval_freq == 0:
            metrics, _ = evaluate(val_loader, eval_step, cfg, device,
                                  logger, flags.ap_iou_thresh)
            history.append(epoch, {"mAP": metrics["mAP"],
                                   "AR": metrics["AR"]}, kind="eval")
    return model, optimizer


def main(recipe: str, argv=None):
    """Parse `argv` (default: the command line) and train `recipe`;
    only "fsb" is ported."""
    if recipe != "fsb":
        raise ValueError(f"recipe {recipe!r} is not ported (only fsb)")
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--train_split", default="train")
    parser.add_argument("--val_split", default="val")
    parser.add_argument("--val_data_root", default=None)
    flags = parser.parse_args(argv)
    return _train_loop_single(flags, recipe)
