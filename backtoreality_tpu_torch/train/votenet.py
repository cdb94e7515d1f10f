"""VoteNet training loops: FSB, WSB, BR and BR+CenterRefine.

Counterpart of ``backtoreality_tpu/train/votenet.py`` (reference
`train_Votenet_{FSB,WSB,BR,BR_CenterRefine}.py`): a train step
(train-mode forward, the recipe's criterion, backward, Adam), host-side
learning-rate and BN-momentum schedules set before each epoch, a
checkpoint of model and optimizer after each epoch, and the reference
evaluation protocol every `eval_freq` epochs. BR and CenterRefine train
on two domains at once: each step runs the source (virtual scenes, full
labels) and then the target (real scenes, weak labels) forward, the BN
running statistics moving through both in that order, and takes one
backward and one Adam step on the domain-adaptation criterion. It runs on
the CUDA card unless ``--device cpu`` is given, and raises if no card is
present and the CPU was not asked for.

Every step is bitwise repeatable (`common.make_deterministic`). With
``--bf16`` the model computes in bfloat16 over float32 parameters and
statistics (``--f32_tail N``: the backbone's last N stages in float32).
Before each evaluation the BN running statistics are recalibrated over
``--bn_recal_batches`` train-mode batches (default 20 with ``--bf16``)
and put back after it: training goes on from the statistics it had, as
the JAX loop's, which recalibrates a copy of its state.

``--query_mode exact`` groups by the reference's first-k query, which a
checkpoint converted by ``tools.torch_import`` was trained with.

Flag names and defaults are the JAX package's. Data parallelism
(``common.launch``): ``--num_devices N`` spawns N local ranks that split
every ``--batch_size`` batch by rows, so the global batch, the loss and
the evaluation's mAP are the single device's; ``--multihost`` runs this
process as one rank of the group the environment describes, reading its
own loader shard, ``--batch_size`` per process and the evaluation per
rank. Every rank computes the global batch's BN moments and criterion,
the gradients are summed over the ranks, and rank 0 writes the
checkpoints, ``metrics.jsonl`` and ``Eval_mAP.txt``. The preemption guard
snapshots the state every ``--guard_every_steps`` steps (saved as the
epoch before, which a resume re-runs) and after each epoch, and writes the
snapshot on SIGTERM. ``--profile_dir`` traces host steps 10-15;
``--ram_cache_gb`` sizes the datasets' RAM cache (0 turns it off).

Usage:
  python -m backtoreality_tpu_torch.train.votenet_fsb --data_root D \
      [--log_dir log_votenet] [--device cpu] [...]
  python -m backtoreality_tpu_torch.train.votenet_br --data_root REAL \
      --source_data_root VIRTUAL [...]
"""

from __future__ import annotations

import argparse
import os
import pathlib

import torch

from backtoreality_tpu_torch import parallel
from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.dataset import DetectionDataset
from backtoreality_tpu_torch.data.loader import DetectionDataLoader, cycle
from backtoreality_tpu_torch.eval import (APCalculator, parse_groundtruths,
                                          parse_predictions)
from backtoreality_tpu_torch.losses import votenet as vote_losses
from backtoreality_tpu_torch.train import common
from backtoreality_tpu_torch.train.common import model_args, to_device
from backtoreality_tpu_torch.train.evaluate import (EVAL_CONFIG_DICT,
                                                    EVAL_KEYS, build_model)
from backtoreality_tpu_torch.train.observability import (ScalarHistory,
                                                         StepTimer,
                                                         TraceWindow)

__all__ = ["add_common_flags", "build_model", "make_train_step",
           "make_da_train_step", "make_recal_step", "recalibrate_bn",
           "make_eval_step", "evaluate", "main"]

make_recal_step = common.make_recal_step
recalibrate_bn = common.recalibrate_bn

RECIPES = ("fsb", "wsb", "br", "br_center_refine")


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
                        choices=["vote_fps", "seed_fps", "random"],
                        help="random: proposals at seeds drawn uniformly,"
                             " from --seed and the step in training and"
                             " alike for every evaluation batch")
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
    parser.add_argument("--resume", action="store_true",
                        help="restore optimizer state + epoch from"
                             " --checkpoint_path and continue")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; pass cpu to run"
                             " on the CPU)")
    return common.add_parallel_flags(parser)


def _draws(batch, seed, optimizer, *stream):
    """The generator of a train forward's random proposal draws, seeded
    from (`seed`, the optimizer's update count, `stream`) alone, as the
    JAX step folds ``state.step`` into ``PRNGKey(seed)``; with several
    ranks, each rank's rows draw apart (its rank folded in too). None
    without a `seed` (the other samplings draw nothing)."""
    if seed is None:
        return None
    key = (seed, common.optimizer_steps(optimizer), *stream)
    if parallel.world() > 1:
        key += (parallel.rank(),)
    return common.draw_generator(batch["point_clouds"].device, *key)


def make_train_step(model, optimizer, criterion, cfg, *, jitter=False,
                    seed=None):
    """step(batch, bn_momentum) -> scalar aux tensors (on the device).

    One train-mode forward, the criterion on the global batch (the ranks'
    rows gathered, ``parallel.gather_rows``), backward and an optimizer
    step; BN running statistics move with `bn_momentum`. With `jitter`,
    the model also takes the batch's centre and class labels. With a
    `seed` (``--cluster_sampling random``), the forward draws its
    proposals from a generator seeded from the seed and the step
    (:func:`_draws`)."""

    def step(batch, bn_momentum):
        def forward_loss():
            end_points = model(*model_args(batch, jitter),
                               _draws(batch, seed, optimizer))
            return criterion(parallel.gather_rows({**batch, **end_points}),
                             cfg)

        return common.update(model, optimizer, bn_momentum, forward_loss)

    return step


def make_da_train_step(model, optimizer, cfg, *, jitter=False, seed=None):
    """step(batch_S, batch_T, bn_momentum, epoch) -> scalar aux tensors.

    The source forward, then the target forward (the BN running
    statistics move through both, in that order), the BR criterion
    (`get_loss_DA`), or with `jitter` the CenterRefine one
    (`get_loss_DA_jitter`, which reads `epoch`), one backward and one
    optimizer step. With a `seed` (``--cluster_sampling random``), each
    domain's forward draws from a generator of its own, seeded from the
    seed, the step and the domain, as the JAX step splits its key."""

    def step(batch_S, batch_T, bn_momentum, epoch):
        def forward_loss():
            ep_S = {**batch_S, **model(*model_args(batch_S, jitter),
                                       _draws(batch_S, seed, optimizer, 0))}
            ep_T = {**batch_T, **model(*model_args(batch_T, jitter),
                                       _draws(batch_T, seed, optimizer, 1))}
            ep_S, ep_T = parallel.gather_rows(ep_S), parallel.gather_rows(ep_T)
            if jitter:
                return vote_losses.get_loss_DA_jitter(ep_S, ep_T, epoch, cfg)
            return vote_losses.get_loss_DA(ep_S, ep_T, cfg)

        return common.update(model, optimizer, bn_momentum, forward_loss)

    return step


def make_eval_step(model, criterion, cfg, *, jitter=False, draws=False):
    """step(batch, sizes=None) -> (predictions for EVAL_KEYS, scalar aux).
    With `sizes` (``--num_devices``: every rank's rows of the global
    batch), the predictions and the criterion are the global batch's.
    With `draws` (``--cluster_sampling random``), every batch draws its
    proposals from a generator seeded alike, as the JAX loop evaluates
    every batch under ``PRNGKey(0)``."""

    def step(batch, sizes=None):
        model.eval()
        generator = (common.draw_generator(batch["point_clouds"].device, 0)
                     if draws else None)
        with torch.no_grad():
            outs = {**batch, **model(*model_args(batch, jitter), generator)}
            if sizes is not None:
                outs = parallel.gather_rows(outs, sizes)
            _, aux = criterion(outs, cfg)
        return {k: outs[k] for k in EVAL_KEYS}, common.scalars(aux)

    return step


def evaluate(loader, eval_step, cfg, device, logger, ap_iou_thresh=0.25,
             split=False):
    """Eval loss means and mAP/AR at `ap_iou_thresh` over `loader`. With
    `split` (``--num_devices``), each rank runs its rows of every batch
    and scores the gathered predictions: the single device's mAP."""
    config_dict = dict(EVAL_CONFIG_DICT, dataset_config=cfg)
    calc = APCalculator(ap_iou_thresh, cfg.class2type)
    meter = common.MetricMeter()
    for batch in loader:
        rows, sizes = (parallel.shard_rows(batch, even=False) if split
                       else (batch, None))
        pred, aux = eval_step(to_device(rows, device), sizes)
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


def _dataset(flags, cfg, root, split, augment, center_jitter=0.0):
    return DetectionDataset(
        cfg, root, split=split, num_points=flags.num_point,
        use_color=flags.use_color, use_height=not flags.no_height,
        augment=augment, center_jitter=center_jitter, seed=flags.seed,
        **common.cache_kw(flags))


def _loader(flags, dataset, **kw):
    """A loader of `dataset` at --batch_size; with --multihost, this
    rank's shard of the scans."""
    shards = parallel.process_shard_info() if flags.multihost else (1, 0)
    return DetectionDataLoader(dataset, flags.batch_size,
                               num_shards=shards[0], shard_index=shards[1],
                               **kw)


def _schedules(flags):
    lr_fn = common.step_lr(
        flags.learning_rate,
        [int(x) for x in flags.lr_decay_steps.split(",")],
        [float(x) for x in flags.lr_decay_rates.split(",")])
    bn_fn = common.bn_momentum_fn(step=flags.bn_decay_step,
                                  rate=flags.bn_decay_rate)
    return lr_fn, bn_fn


def _setup(flags, device, kind):
    """Config, logger, model (seeded) and its Adam."""
    cfg = get_config(flags.dataset)
    logger = common.setup_logger(flags.log_dir)
    common.dump_config(flags.log_dir, vars(flags))
    torch.manual_seed(flags.seed)
    model = build_model(flags, cfg, kind).to(device)
    optimizer = common.make_optimizer(
        model.parameters(), "adam", flags.weight_decay,
        lr0=flags.learning_rate)
    return cfg, logger, model, optimizer


def _resume(model, optimizer, path, logger):
    """Model and optimizer state from a training checkpoint; returns the
    epoch to start at."""
    ckpt = common.load_checkpoint(path)
    if "optimizer" not in ckpt:
        raise ValueError(f"--resume needs a training checkpoint; {path}"
                         " holds weights only")
    model.load_state_dict(ckpt["model"])
    optimizer.load_state_dict(ckpt["optimizer"])
    logger.info("restored full state from %s (epoch %d)", path,
                ckpt["epoch"])
    return ckpt["epoch"] + 1


def _sampling_seed(flags) -> int | None:
    """``--seed`` under ``--cluster_sampling random`` (the steps' draws
    are seeded from it), else None."""
    return flags.seed if flags.cluster_sampling == "random" else None


def _split(flags) -> bool:
    """``--num_devices`` with several ranks: every rank reads the whole
    global batch and keeps its rows."""
    return parallel.world() > 1 and not flags.multihost


def _rows(flags):
    """batch -> this rank's rows of it (all of it unless :func:`_split`)."""
    if _split(flags):
        return lambda batch: parallel.shard_rows(batch)[0]
    return lambda batch: batch


def _train_loop_single(flags, device, recipe):
    """FSB (full labels) / WSB (weak, centre-jittered labels). Returns
    the trained model and its optimizer."""
    cfg, logger, model, optimizer = _setup(flags, device, "plain")
    jitter = 0.0 if recipe == "fsb" else flags.center_jitter
    train_ds = _dataset(flags, cfg, flags.data_root, flags.train_split,
                        augment=True, center_jitter=jitter)
    val_ds = _dataset(flags, cfg, flags.val_data_root or flags.data_root,
                      flags.val_split, augment=False)
    train_loader = _loader(flags, train_ds, seed=flags.seed)
    val_loader = _loader(flags, val_ds, shuffle=False, drop_last=False)
    logger.info("train scans: %d, val scans: %d", len(train_ds),
                len(val_ds))
    criterion = (vote_losses.get_loss if recipe == "fsb"
                 else vote_losses.get_loss_weak)

    start_epoch = 0
    if flags.checkpoint_path and flags.resume:
        start_epoch = _resume(model, optimizer, flags.checkpoint_path,
                              logger)
    elif flags.checkpoint_path:
        # the JAX package's checkpoints too: the weights only, as its
        # `restore_state(..., restore_opt=False)`
        common.restore_weights(model, flags.checkpoint_path, "VoteNet",
                               logger.info)
    parallel.replicate(model)
    parallel.check_same(len(train_loader), "train batches an epoch")
    history = ScalarHistory(flags.log_dir)

    seed = _sampling_seed(flags)
    train_step = make_train_step(model, optimizer, criterion, cfg, seed=seed)
    eval_step = make_eval_step(model, criterion, cfg,
                               draws=seed is not None)
    recal_step = common.make_recal_step(model)
    recal_loader = (parallel.ShardedRows(train_loader) if _split(flags)
                    else train_loader)
    rows = _rows(flags)
    lr_fn, bn_fn = _schedules(flags)
    ckpt_path = os.path.join(flags.log_dir, "checkpoint.tar")
    guard = common.PreemptionGuard(ckpt_path, logger)
    trace = TraceWindow(flags.profile_dir)
    timer = StepTimer()
    host_step = 0
    try:
        for epoch in range(start_epoch, flags.max_epoch):
            common.set_learning_rate(optimizer, lr_fn(epoch))
            bnm = bn_fn(epoch)
            train_loader.set_epoch(epoch)
            timer.reset()
            aux_hist = []
            for batch in train_loader:
                host_step += 1
                trace.before(host_step)
                aux_hist.append(train_step(to_device(rows(batch), device),
                                           bnm))
                trace.after(host_step)
                timer.tick(flags.batch_size)
                if (flags.guard_every_steps
                        and len(aux_hist) % flags.guard_every_steps == 0):
                    # saved as the epoch before: a resume re-runs this one
                    guard.update(model, optimizer, epoch - 1)
            means = common.fetch_aux_means(aux_hist)  # waits for the device
            logger.info(
                "epoch %03d lr %.2e bnm %.3f loss %.4f obj_acc %.3f "
                "(%d batches, %.1fs, %.2f scenes/s)",
                epoch, lr_fn(epoch), bnm, means.get("loss", float("nan")),
                means.get("obj_acc", float("nan")), timer.steps,
                timer.elapsed, timer.scenes_per_sec)
            history.append(epoch, means, lr=lr_fn(epoch),
                           scenes_per_sec=timer.scenes_per_sec)
            guard.update(model, optimizer, epoch)
            common.save_checkpoint(ckpt_path, model, optimizer, epoch)
            if (epoch + 1) % flags.eval_freq == 0:
                with common.buffers_kept(model):
                    common.recalibrate_bn(recal_loader, recal_step, device,
                                          common.recal_batches(flags))
                    metrics, _ = evaluate(val_loader, eval_step, cfg, device,
                                          logger, flags.ap_iou_thresh,
                                          _split(flags))
                history.append(epoch, {"mAP": metrics["mAP"],
                                       "AR": metrics["AR"]}, kind="eval")
    finally:
        trace.close()
        guard.close()
    return model, optimizer


def _train_loop_da(flags, device, recipe):
    """BR (DA) / BR+CenterRefine (DA + jitter head). Returns the trained
    model and its optimizer."""
    jitter_model = recipe == "br_center_refine"
    cfg, logger, model, optimizer = _setup(
        flags, device, "da_jitter" if jitter_model else "da")

    # CenterRefine jitters the SOURCE labels too
    # (`train_Votenet_BR_CenterRefine.py:152-154`); BR trains the source
    # with its full exact labels (`train_Votenet_BR.py:165-167`)
    train_ds_S = _dataset(
        flags, cfg, flags.source_data_root, "train_aug", augment=True,
        center_jitter=flags.center_jitter if jitter_model else 0.0)
    train_ds_T = _dataset(flags, cfg, flags.data_root, flags.train_split,
                          augment=True, center_jitter=flags.center_jitter)
    val_ds = _dataset(flags, cfg, flags.val_data_root or flags.data_root,
                      flags.val_split, augment=False)
    loader_S = _loader(flags, train_ds_S, seed=flags.seed)
    loader_T = _loader(flags, train_ds_T, seed=flags.seed + 1)
    val_loader = _loader(flags, val_ds, shuffle=False, drop_last=False)
    logger.info("S scans: %d, T scans: %d, val: %d", len(train_ds_S),
                len(train_ds_T), len(val_ds))

    ckpt_name = ("train_BR_CenterRefine.tar" if jitter_model
                 else "train_BR.tar")
    ckpt_path = os.path.join(flags.log_dir, ckpt_name)
    start_epoch = 0
    if flags.resume:
        # resume this stage in place: model, optimizer and epoch from
        # the stage's own checkpoint, or --checkpoint_path if given
        src = flags.checkpoint_path or ckpt_path
        if pathlib.Path(src).exists():
            start_epoch = _resume(model, optimizer, src, logger)
        else:
            logger.info("--resume: no checkpoint at %s, fresh start", src)
    elif flags.checkpoint_path:
        # cross-stage grafting: BR weights into the jitter-augmented
        # model (reference `strict=False`,
        # `train_Votenet_BR_CenterRefine.py:213-218`)
        state, ckpt_epoch = common.load_weights(flags.checkpoint_path)
        common.partial_restore(model, state, log=logger.info)
        logger.info("grafted checkpoint %s (epoch %s)",
                    flags.checkpoint_path, ckpt_epoch)
    parallel.replicate(model)
    steps_per_epoch = min(len(loader_S), len(loader_T))
    parallel.check_same(steps_per_epoch, "train steps an epoch")
    history = ScalarHistory(flags.log_dir)

    seed = _sampling_seed(flags)
    train_step = make_da_train_step(model, optimizer, cfg,
                                    jitter=jitter_model, seed=seed)
    # eval uses the weak criterion on the target domain
    eval_step = make_eval_step(model, vote_losses.get_loss_weak, cfg,
                               jitter=jitter_model, draws=seed is not None)
    recal_step = common.make_recal_step(model, jitter=jitter_model)
    recal_loader = (parallel.ShardedRows(loader_T) if _split(flags)
                    else loader_T)
    rows = _rows(flags)
    lr_fn, bn_fn = _schedules(flags)
    guard = common.PreemptionGuard(ckpt_path, logger)
    trace = TraceWindow(flags.profile_dir)
    timer = StepTimer()
    host_step = 0
    try:
        for epoch in range(start_epoch, flags.max_epoch):
            common.set_learning_rate(optimizer, lr_fn(epoch))
            bnm = bn_fn(epoch)
            loader_S.set_epoch(epoch)
            loader_T.set_epoch(epoch)
            # zip the short loader with a cycle of the longer one
            # (`train_Votenet_BR.py:267`)
            if len(loader_S) <= len(loader_T):
                pairs = zip(cycle(loader_S), loader_T)
            else:
                pairs = zip(loader_S, cycle(loader_T))
            timer.reset()
            aux_hist = []
            for batch_S, batch_T in pairs:
                host_step += 1
                trace.before(host_step)
                aux_hist.append(train_step(
                    to_device(rows(batch_S), device),
                    to_device(rows(batch_T), device), bnm, epoch))
                trace.after(host_step)
                timer.tick(flags.batch_size)
                if (flags.guard_every_steps
                        and len(aux_hist) % flags.guard_every_steps == 0):
                    # saved as the epoch before: a resume re-runs this one
                    guard.update(model, optimizer, epoch - 1)
                if len(aux_hist) >= steps_per_epoch:
                    break
            means = common.fetch_aux_means(aux_hist)  # waits for the device
            logger.info(
                "epoch %03d lr %.2e loss %.4f obj_acc %.3f "
                "(%d pair-batches, %.1fs)",
                epoch, lr_fn(epoch), means.get("loss", float("nan")),
                means.get("obj_acc", float("nan")), timer.steps,
                timer.elapsed)
            history.append(epoch, means, lr=lr_fn(epoch),
                           scenes_per_sec=timer.scenes_per_sec)
            guard.update(model, optimizer, epoch)
            common.save_checkpoint(ckpt_path, model, optimizer, epoch)
            if (epoch + 1) % flags.eval_freq == 0:
                # the target's train batches, as the JAX loop's
                with common.buffers_kept(model):
                    common.recalibrate_bn(recal_loader, recal_step, device,
                                          common.recal_batches(flags))
                    metrics, _ = evaluate(val_loader, eval_step, cfg, device,
                                          logger, flags.ap_iou_thresh,
                                          _split(flags))
                history.append(epoch, {"mAP": metrics["mAP"],
                                       "AR": metrics["AR"]}, kind="eval")
                if parallel.rank() == 0:
                    with open(os.path.join(flags.log_dir, "Eval_mAP.txt"),
                              "a") as f:
                        f.write(f"{epoch}\t{metrics['mAP']:.4f}\n")
    finally:
        trace.close()
        guard.close()
    return model, optimizer


def _train(flags, device, recipe):
    if recipe in ("fsb", "wsb"):
        return _train_loop_single(flags, device, recipe)
    return _train_loop_da(flags, device, recipe)


def main(recipe: str, argv=None):
    """Parse `argv` (default: the command line) and train `recipe`, one
    of fsb, wsb, br and br_center_refine. Returns the trained model and
    its optimizer; with ``--num_devices`` above 1, None (the ranks ran in
    processes of their own; the state is in the checkpoint)."""
    if recipe not in RECIPES:
        raise ValueError(f"unknown recipe {recipe!r}")
    common.make_deterministic()
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--train_split", default="train")
    parser.add_argument("--val_split", default="val")
    parser.add_argument("--val_data_root", default=None)
    if recipe in ("wsb", "br", "br_center_refine"):
        parser.add_argument("--center_jitter", type=float, default=0.1)
    if recipe in ("br", "br_center_refine"):
        parser.add_argument("--source_data_root", required=True,
                            help="virtual-scene data root (obj_aug)")
        parser.add_argument("--dataset_version", default="point",
                            choices=["point", "mesh"])
    flags = parser.parse_args(argv)
    if flags.cluster_sampling == "random" and common.recal_batches(flags):
        # the JAX loop's recalibration step passes no rng, and its random
        # proposal module asserts on one
        parser.error("--cluster_sampling random draws its proposals from"
                     " a generator that a train or evaluation step passes;"
                     " BN recalibration's forwards have none, as in the JAX"
                     " package: pass --bn_recal_batches 0")
    return common.launch(_train, flags, recipe)
