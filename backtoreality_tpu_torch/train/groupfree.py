"""GroupFree3D training loops: FSB and WSB.

Counterpart of ``backtoreality_tpu/train/groupfree.py`` (reference
`train_GF_{FSB,WSB}.py`): a train step (train-mode forward with dropout,
the recipe's criterion, backward, the gradients clipped to a global norm
of 0.1, AdamW with a learning rate of its own for the decoder, both set
from per-iteration warmup and step or cosine schedules), a constant BN
momentum, checkpoints of model and optimizer, and the reference
evaluation protocol (per-prefix AP, confidence threshold 0.0) every
`val_freq` epochs. It runs on the CUDA card unless ``--device cpu`` is
given, and raises if no card is present and the CPU was not asked for.

Flag names and defaults are the JAX package's (`train_GF_FSB.py:23-103`).
Not ported, and so refused by the parser: ``--num_devices``, ``--bf16``,
``--f32_tail``, ``--bn_recal_batches`` (and with it BN recalibration
before evaluation), ``--multihost``, ``--guard_every_steps``,
``--profile_dir``, ``--ram_cache_gb`` (the datasets keep their default
RAM cache of 8 GiB) and ``--query_mode exact``. The BR and
BR+CenterRefine recipes wait for the DA and jitter models (ROADMAP.md,
A.8).

Usage:
  python -m backtoreality_tpu_torch.train.gf_fsb --data_root D \
      [--log_dir log_gf] [--device cpu] [...]
  python -m backtoreality_tpu_torch.train.gf_wsb --data_root D [...]
"""

from __future__ import annotations

import argparse
import pathlib
import time

import torch

from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.dataset import DetectionDataset
from backtoreality_tpu_torch.data.loader import DetectionDataLoader
from backtoreality_tpu_torch.eval import (APCalculator, parse_groundtruths,
                                          parse_predictions)
from backtoreality_tpu_torch.losses import groupfree as gf_losses
from backtoreality_tpu_torch.models.groupfree import GroupFreeDetector
from backtoreality_tpu_torch.nn import set_bn_momentum
from backtoreality_tpu_torch.train import common
from backtoreality_tpu_torch.train.common import to_device
from backtoreality_tpu_torch.train.observability import ScalarHistory

__all__ = ["add_flags", "build_model", "loss_kwargs", "eval_prefixes",
           "make_train_step", "make_eval_step", "evaluate", "main"]

RECIPES = ("fsb", "wsb")

GF_EVAL_CONFIG_DICT = dict(
    remove_empty_box=False, use_3d_nms=True, nms_iou=0.25,
    use_old_type_nms=False, cls_nms=True, per_class_proposal=True,
    conf_thresh=0.0,
)

EVAL_KEY_SUFFIXES = (
    "center", "heading_scores", "heading_residuals", "size_scores",
    "size_residuals", "sem_cls_scores", "objectness_scores",
)


def add_flags(parser: argparse.ArgumentParser):
    # Model
    parser.add_argument("--width", default=1, type=int)
    parser.add_argument("--num_target", type=int, default=256)
    parser.add_argument("--sampling", default="kps", choices=["kps", "fps"])
    # Transformer
    parser.add_argument("--nhead", default=8, type=int)
    parser.add_argument("--num_decoder_layers", default=6, type=int)
    parser.add_argument("--dim_feedforward", default=2048, type=int)
    parser.add_argument("--transformer_dropout", default=0.1, type=float)
    parser.add_argument("--self_position_embedding", default="loc_learned",
                        choices=["none", "xyz_learned", "loc_learned"])
    parser.add_argument("--cross_position_embedding",
                        default="xyz_learned",
                        choices=["none", "xyz_learned"])
    # Loss
    parser.add_argument("--query_points_generator_loss_coef", default=0.8,
                        type=float)
    parser.add_argument("--obj_loss_coef", default=0.1, type=float)
    parser.add_argument("--box_loss_coef", default=1.0, type=float)
    parser.add_argument("--sem_cls_loss_coef", default=0.1, type=float)
    parser.add_argument("--center_loss_type", default="smoothl1")
    parser.add_argument("--center_delta", default=1.0, type=float)
    parser.add_argument("--size_loss_type", default="smoothl1")
    parser.add_argument("--size_delta", default=1.0, type=float)
    parser.add_argument("--heading_loss_type", default="smoothl1")
    parser.add_argument("--heading_delta", default=1.0, type=float)
    parser.add_argument("--query_points_obj_topk", default=4, type=int)
    # Data
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--dataset", default="scannet_md40",
                        choices=["scannet_md40", "matterport_md40"])
    parser.add_argument("--data_root", default="data")
    parser.add_argument("--num_point", type=int, default=50000)
    parser.add_argument("--use_height", action="store_true")
    parser.add_argument("--use_color", action="store_true")
    # Training
    parser.add_argument("--max_epoch", type=int, default=400)
    parser.add_argument("--weight_decay", type=float, default=0.0005)
    parser.add_argument("--learning_rate", type=float, default=0.004)
    parser.add_argument("--decoder_learning_rate", type=float,
                        default=0.0004)
    parser.add_argument("--lr-scheduler", dest="lr_scheduler", type=str,
                        default="step", choices=["step", "cosine"])
    parser.add_argument("--warmup-epoch", dest="warmup_epoch", type=int,
                        default=-1)
    parser.add_argument("--warmup-multiplier", dest="warmup_multiplier",
                        type=int, default=100)
    parser.add_argument("--lr_decay_epochs", type=int, default=[280, 340],
                        nargs="+")
    parser.add_argument("--lr_decay_rate", type=float, default=0.1)
    parser.add_argument("--clip_norm", default=0.1, type=float)
    parser.add_argument("--bn_momentum", type=float, default=0.1)
    # io
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--log_dir", default="log_gf")
    parser.add_argument("--save_freq", type=int, default=100)
    parser.add_argument("--val_freq", type=int, default=50)
    parser.add_argument("--ap_iou_thresholds", type=float,
                        default=[0.25, 0.5], nargs="+")
    parser.add_argument("--rng_seed", type=int, default=0)
    parser.add_argument("--query_mode", default="stratified",
                        choices=["stratified"])
    parser.add_argument("--fps_candidates", type=int, default=None,
                        help="subset-FPS at SA1: sample from the first"
                             " K (pre-shuffled) points")
    parser.add_argument("--resume", action="store_true",
                        help="restore full state + epoch from"
                             " --checkpoint_path (default: this run's"
                             " last checkpoint) and continue")
    parser.add_argument("--train_split", default="train")
    parser.add_argument("--val_split", default="val")
    parser.add_argument("--val_data_root", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; pass cpu to run"
                             " on the CPU)")
    return parser


def _input_dim(flags) -> int:
    return int(flags.use_height) + 3 * int(flags.use_color)


def build_model(flags, cfg) -> GroupFreeDetector:
    """The plain GroupFree3D detector at `flags`."""
    return GroupFreeDetector(
        num_class=cfg.num_class,
        num_heading_bin=cfg.num_heading_bin,
        num_size_cluster=cfg.num_size_cluster,
        mean_size_arr=cfg.mean_size_arr,
        input_feature_dim=_input_dim(flags),
        width=flags.width,
        num_proposal=flags.num_target,
        sampling=flags.sampling,
        dropout_rate=flags.transformer_dropout,
        nhead=flags.nhead,
        num_decoder_layers=flags.num_decoder_layers,
        dim_feedforward=flags.dim_feedforward,
        self_position_embedding=flags.self_position_embedding,
        cross_position_embedding=flags.cross_position_embedding,
        query_mode=flags.query_mode,
        fps_candidates=flags.fps_candidates)


def loss_kwargs(flags) -> dict:
    """The criteria's keyword arguments from `flags`."""
    return dict(
        num_decoder_layers=flags.num_decoder_layers,
        query_points_generator_loss_coef=(
            flags.query_points_generator_loss_coef),
        obj_loss_coef=flags.obj_loss_coef,
        box_loss_coef=flags.box_loss_coef,
        sem_cls_loss_coef=flags.sem_cls_loss_coef,
        query_points_obj_topk=flags.query_points_obj_topk,
        center_loss_type=flags.center_loss_type,
        center_delta=flags.center_delta,
        size_loss_type=flags.size_loss_type,
        size_delta=flags.size_delta,
        heading_loss_type=flags.heading_loss_type,
        heading_delta=flags.heading_delta,
    )


def eval_prefixes(flags) -> tuple[str, ...]:
    """The head that is scored: the last decoder layer's, or the
    proposal head's when there is no decoder."""
    return ("last_",) if flags.num_decoder_layers > 0 else ("proposal_",)


def make_train_step(model, optimizer, criterion, cfg, loss_kw):
    """step(batch, bn_momentum) -> scalar aux tensors (on the device).

    One train-mode forward (dropout on), the criterion, backward and an
    optimizer step (which clips and sets its learning rates itself, see
    `common.make_gf_optimizer`); BN running statistics move with
    `bn_momentum`."""

    def step(batch, bn_momentum):
        model.train()
        set_bn_momentum(model, bn_momentum)
        end_points = model(batch["point_clouds"])
        loss, aux = criterion({**batch, **end_points}, cfg, **loss_kw)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return common.scalars(aux)

    return step


def make_eval_step(model, criterion, cfg, loss_kw, prefixes):
    """step(batch) -> (the scored heads' predictions, scalar aux)."""
    keys = [p + s for p in prefixes for s in EVAL_KEY_SUFFIXES]

    def step(batch):
        model.eval()
        with torch.no_grad():
            outs = model(batch["point_clouds"])
            _, aux = criterion({**batch, **outs}, cfg, **loss_kw)
        return {k: outs[k] for k in keys}, common.scalars(aux)

    return step


def evaluate(loader, eval_step, cfg, device, logger, flags, prefixes):
    """mAP/AR per (prefix, IoU threshold) over `loader`, and the eval
    loss means."""
    config_dict = dict(GF_EVAL_CONFIG_DICT, dataset_config=cfg)
    calcs = {(p, t): APCalculator(t, cfg.class2type)
             for p in prefixes for t in flags.ap_iou_thresholds}
    meter = common.MetricMeter()
    for batch in loader:
        pred, aux = eval_step(to_device(batch, device))
        meter.update({k: v.item() for k, v in aux.items()})
        pred_np = {k: v.cpu().numpy() for k, v in pred.items()}
        gts = parse_groundtruths(batch, config_dict)
        for prefix in prefixes:
            preds = parse_predictions(pred_np, config_dict, prefix)
            for t in flags.ap_iou_thresholds:
                calcs[(prefix, t)].step(preds, gts)
    results = {}
    for (prefix, t), calc in calcs.items():
        results[(prefix, t)] = metrics = calc.compute_metrics()
        if logger:
            logger.info("eval [%s] mAP@%.2f: %.4f  AR: %.4f", prefix, t,
                        metrics["mAP"], metrics["AR"])
    return results, meter.means()


def _make_datasets(flags, cfg, recipe):
    """(train, val) datasets with GF's labels; WSB jitters the centres."""
    kw = dict(num_points=flags.num_point, use_color=flags.use_color,
              use_height=flags.use_height, seed=flags.rng_seed,
              gf_labels=True)
    train_ds = DetectionDataset(
        cfg, flags.data_root, split=flags.train_split, augment=True,
        center_jitter=0.0 if recipe == "fsb" else flags.center_jitter, **kw)
    val_ds = DetectionDataset(
        cfg, flags.val_data_root or flags.data_root, split=flags.val_split,
        augment=False, **kw)
    return train_ds, val_ds


def main(recipe: str, argv=None):
    """Parse `argv` (default: the command line) and train `recipe`, fsb or
    wsb. Returns the trained model and its optimizer."""
    if recipe in ("br", "br_center_refine"):
        raise SystemExit(f"GroupFree3D {recipe} is not ported yet: it needs"
                         " the DA and jitter models (ROADMAP.md, A.8)")
    if recipe not in RECIPES:
        raise ValueError(f"unknown recipe {recipe!r}")
    parser = argparse.ArgumentParser()
    add_flags(parser)
    if recipe == "wsb":
        parser.add_argument("--center_jitter", type=float, default=0.1)
    flags = parser.parse_args(argv)

    device = common.resolve_device(flags.device)
    cfg = get_config(flags.dataset)
    logger = common.setup_logger(flags.log_dir, name="gf")
    common.dump_config(flags.log_dir, vars(flags))
    train_ds, val_ds = _make_datasets(flags, cfg, recipe)
    train_loader = DetectionDataLoader(train_ds, flags.batch_size,
                                       seed=flags.rng_seed)
    val_loader = DetectionDataLoader(val_ds, flags.batch_size,
                                     shuffle=False, drop_last=False)
    logger.info("train scans: %d, val scans: %d", len(train_ds),
                len(val_ds))

    torch.manual_seed(flags.rng_seed)
    model = build_model(flags, cfg).to(device)
    steps_per_epoch = len(train_loader)
    optimizer = common.make_gf_optimizer(
        model,
        common.make_gf_schedule(flags.learning_rate, flags, steps_per_epoch),
        common.make_gf_schedule(flags.decoder_learning_rate, flags,
                                steps_per_epoch),
        flags.weight_decay, flags.clip_norm)
    loss_kw = loss_kwargs(flags)
    criterion = (gf_losses.get_loss if recipe == "fsb"
                 else gf_losses.get_loss_weak)

    ckpt_path = pathlib.Path(flags.log_dir) / "ckpt_epoch_last.tar"
    start_epoch = 0
    if flags.resume:
        # the run's own last checkpoint, or --checkpoint_path if given
        src = flags.checkpoint_path or ckpt_path
        if pathlib.Path(src).exists():
            ckpt = common.load_checkpoint(src)
            model.load_state_dict(ckpt["model"])
            optimizer.load_state_dict(ckpt["optimizer"])
            start_epoch = ckpt["epoch"] + 1
            logger.info("resumed %s (epoch %d)", src, ckpt["epoch"])
        else:
            logger.info("--resume: no checkpoint at %s, fresh start", src)
    elif flags.checkpoint_path:
        # the weights only (the JAX package's checkpoints too), as its
        # partial restore of params and batch_stats
        common.restore_weights(model, flags.checkpoint_path, "GroupFree3D",
                               logger.info)
    history = ScalarHistory(flags.log_dir)

    train_step = make_train_step(model, optimizer, criterion, cfg, loss_kw)
    prefixes = eval_prefixes(flags)
    eval_step = make_eval_step(model, criterion, cfg, loss_kw, prefixes)
    for epoch in range(start_epoch, flags.max_epoch):
        train_loader.set_epoch(epoch)
        t0 = time.time()
        aux_hist = [train_step(to_device(batch, device), flags.bn_momentum)
                    for batch in train_loader]
        means = common.fetch_aux_means(aux_hist)  # waits for the device
        dt = time.time() - t0
        nb = len(aux_hist)
        lr = optimizer.param_groups[0]["lr"]  # the epoch's last step's
        logger.info("epoch %03d lr %.2e loss %.4f (%d batches, %.1fs, "
                    "%.2f scenes/s)", epoch, lr,
                    means.get("loss", float("nan")), nb, dt,
                    nb * flags.batch_size / max(dt, 1e-9))
        history.append(epoch, means, lr=lr,
                       scenes_per_sec=nb * flags.batch_size
                       / max(dt, 1e-9))
        if (epoch + 1) % flags.save_freq == 0 or \
                epoch == flags.max_epoch - 1:
            common.save_checkpoint(
                pathlib.Path(flags.log_dir) / f"ckpt_epoch_{epoch}.tar",
                model, optimizer, epoch)
        common.save_checkpoint(ckpt_path, model, optimizer, epoch)
        if (epoch + 1) % flags.val_freq == 0:
            results, _ = evaluate(val_loader, eval_step, cfg, device,
                                  logger, flags, prefixes)
            first = results[(prefixes[0], flags.ap_iou_thresholds[0])]
            history.append(epoch, {
                "mAP": first["mAP"], "AR": first["AR"],
                **{f"mAP@{t}": results[(prefixes[0], t)]["mAP"]
                   for t in flags.ap_iou_thresholds}}, kind="eval")
    return model, optimizer
