"""GroupFree3D training loops: FSB, WSB, BR and BR+CenterRefine.

Counterpart of ``backtoreality_tpu/train/groupfree.py`` (reference
`train_GF_{FSB,WSB,BR,BR_CenterRefine}.py`): a train step (train-mode
forward with dropout, the recipe's criterion, backward, the gradients
clipped to a global norm of 0.1, AdamW with a learning rate of its own for
the decoder, both set from per-iteration warmup and step or cosine
schedules), a constant BN momentum, checkpoints of model and optimizer,
and the reference evaluation protocol (per-prefix AP, confidence
threshold 0.0) every `val_freq` epochs. BR and BR+CenterRefine train on
two domains at once: each step runs the source (virtual scenes, full
labels) and then the target (real scenes, weak labels) forward, each with
its own dropout draws and the BN running statistics moving through both in
that order, and takes one backward, one clip and one AdamW step on the
domain-adaptation criterion; both domains' centres are jittered. It runs
on the CUDA card unless ``--device cpu`` is given, and raises if no card
is present and the CPU was not asked for.

Every step is bitwise repeatable (`common.make_deterministic`; the
dropout masks are the global RNG's, seeded by ``--rng_seed``). With
``--bf16`` the model computes in bfloat16 over float32 parameters and
statistics (``--f32_tail N``: the backbone's last N stages in float32).
Before each evaluation the BN running statistics are recalibrated over
``--bn_recal_batches`` train-mode batches (default 20 with ``--bf16``),
the dropout masks drawn from a generator of its own seeded alike for
every batch (the JAX package passes one fixed key), and put back after
the evaluation, as the JAX loop recalibrates a copy of its state.

Flag names and defaults are the JAX package's (`train_GF_FSB.py:23-103`).
Data parallelism as VoteNet's trainers (``common.launch``):
``--num_devices N`` spawns N local ranks that split every batch by rows;
``--multihost`` runs one rank of the group the environment describes on
its own loader shard. Every rank computes the global batch's BN moments
and criterion, the gradients are summed over the ranks before the clip,
the learning rates follow the count of updates (the same on every rank),
and each rank draws its dropout from the global RNG seeded by
``--rng_seed`` plus its rank (rank 0's draws are the single device's).
The preemption guard snapshots the state every ``--guard_every_steps``
steps and after each epoch; ``--profile_dir`` traces host steps 10-15
(the JAX loop parses the flag and never reads it); ``--ram_cache_gb``
sizes the datasets' RAM cache.
``--query_mode exact`` groups by the reference's first-k query, the mode
a checkpoint imported by ``tools.torch_import`` was trained in.

Usage:
  python -m backtoreality_tpu_torch.train.gf_fsb --data_root D \
      [--log_dir log_gf] [--device cpu] [...]
  python -m backtoreality_tpu_torch.train.gf_wsb --data_root D [...]
  python -m backtoreality_tpu_torch.train.gf_br --data_root REAL \
      --source_data_root VIRTUAL [...]
  python -m backtoreality_tpu_torch.train.gf_br_center_refine \
      --data_root REAL --source_data_root VIRTUAL \
      [--checkpoint_path BR_LOG/ckpt_epoch_last.tar] [...]
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib

import torch

from backtoreality_tpu_torch import parallel
from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.dataset import DetectionDataset
from backtoreality_tpu_torch.data.loader import DetectionDataLoader, cycle
from backtoreality_tpu_torch.eval import (APCalculator, parse_groundtruths,
                                          parse_predictions)
from backtoreality_tpu_torch.losses import groupfree as gf_losses
from backtoreality_tpu_torch.models.groupfree import (
    GroupFreeDetector, GroupFreeDetectorDA, GroupFreeDetectorDAJitter)
from backtoreality_tpu_torch.models.groupfree.transformer import \
    set_dropout_generator
from backtoreality_tpu_torch.train import common
from backtoreality_tpu_torch.train.common import model_args, to_device
from backtoreality_tpu_torch.train.observability import (ScalarHistory,
                                                         StepTimer,
                                                         TraceWindow)

__all__ = ["add_flags", "build_model", "loss_kwargs", "eval_prefixes",
           "make_train_step", "make_da_train_step", "recal_dropout",
           "make_recal_step", "recalibrate_bn", "make_eval_step",
           "evaluate", "main"]

make_recal_step = common.make_recal_step
recalibrate_bn = common.recalibrate_bn

RECIPES = ("fsb", "wsb", "br", "br_center_refine")
MODELS = {"plain": GroupFreeDetector, "da": GroupFreeDetectorDA,
          "da_jitter": GroupFreeDetectorDAJitter}

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
                             " stages (fp2, fp1, sa4, ...) in f32 —"
                             " negligible HBM traffic, full-precision"
                             " seed features for the decoder")
    parser.add_argument("--bn_recal_batches", type=int, default=None,
                        help="train-mode batches to refresh BN stats"
                             " before eval (default 20 with --bf16)")
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
    return common.add_parallel_flags(parser)


def _input_dim(flags) -> int:
    return int(flags.use_height) + 3 * int(flags.use_color)


def build_model(flags, cfg, kind: str = "plain") -> GroupFreeDetector:
    """The GroupFree3D detector of `kind` (plain, da or da_jitter) at
    `flags`."""
    return MODELS[kind](
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
        fps_candidates=flags.fps_candidates,
        dtype=common.compute_dtype(flags),
        f32_tail=flags.f32_tail)


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


def make_train_step(model, optimizer, criterion, cfg, loss_kw, *,
                    jitter=False):
    """step(batch, bn_momentum) -> scalar aux tensors (on the device).

    One train-mode forward (dropout on), the criterion on the global
    batch (``parallel.gather_rows``), backward and an optimizer step
    (which clips and sets its learning rates itself, see
    `common.make_gf_optimizer`); BN running statistics move with
    `bn_momentum`. With `jitter`, the model also takes the batch's centre
    and class labels."""

    def step(batch, bn_momentum):
        def forward_loss():
            end_points = model(*model_args(batch, jitter))
            return criterion(parallel.gather_rows({**batch, **end_points}),
                             cfg, **loss_kw)

        return common.update(model, optimizer, bn_momentum, forward_loss)

    return step


def make_da_train_step(model, optimizer, cfg, loss_kw, *, jitter=False):
    """step(batch_S, batch_T, bn_momentum, epoch) -> scalar aux tensors.

    The source forward, then the target forward (each draws its own
    dropout; the BN running statistics move through both, in that order),
    the BR criterion (`get_loss_DA`), or with `jitter` the CenterRefine
    one (`get_loss_DA_jitter`, which reads `epoch`), one backward and one
    optimizer step."""

    def step(batch_S, batch_T, bn_momentum, epoch):
        def forward_loss():
            ep_S = {**batch_S, **model(*model_args(batch_S, jitter))}
            ep_T = {**batch_T, **model(*model_args(batch_T, jitter))}
            ep_S, ep_T = parallel.gather_rows(ep_S), parallel.gather_rows(ep_T)
            if jitter:
                return gf_losses.get_loss_DA_jitter(ep_S, ep_T, epoch, cfg,
                                                    **loss_kw)
            return gf_losses.get_loss_DA(ep_S, ep_T, cfg, **loss_kw)

        return common.update(model, optimizer, bn_momentum, forward_loss)

    return step


@contextlib.contextmanager
def recal_dropout(model, seed: int = 0):
    """Within, the dropout masks of `model` come from a generator of its
    own, which the returned callable seeds with `seed` (a recalibration
    calls it before each forward); the global RNG is not touched. The
    JAX package recalibrates under one fixed dropout key
    (`backtoreality_tpu/train/groupfree.py:314-345`); its draws cannot
    be replayed, only their being fixed."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    set_dropout_generator(model, generator)
    try:
        yield lambda: generator.manual_seed(seed)
    finally:
        set_dropout_generator(model, None)


def make_eval_step(model, criterion, cfg, loss_kw, prefixes, *,
                   jitter=False):
    """step(batch, sizes=None) -> (the scored heads' predictions, scalar
    aux). The jitter model takes the batch's centre and class labels here
    too. With `sizes` (``--num_devices``: every rank's rows of the global
    batch), the predictions and the criterion are the global batch's."""
    keys = [p + s for p in prefixes for s in EVAL_KEY_SUFFIXES]

    def step(batch, sizes=None):
        model.eval()
        with torch.no_grad():
            outs = {**batch, **model(*model_args(batch, jitter))}
            if sizes is not None:
                outs = parallel.gather_rows(outs, sizes)
            _, aux = criterion(outs, cfg, **loss_kw)
        return {k: outs[k] for k in keys}, common.scalars(aux)

    return step


def evaluate(loader, eval_step, cfg, device, logger, flags, prefixes,
             split=False):
    """mAP/AR per (prefix, IoU threshold) over `loader`, and the eval
    loss means. With `split` (``--num_devices``), each rank runs its rows
    of every batch and scores the gathered predictions."""
    config_dict = dict(GF_EVAL_CONFIG_DICT, dataset_config=cfg)
    calcs = {(p, t): APCalculator(t, cfg.class2type)
             for p in prefixes for t in flags.ap_iou_thresholds}
    meter = common.MetricMeter()
    for batch in loader:
        rows, sizes = (parallel.shard_rows(batch, even=False) if split
                       else (batch, None))
        pred, aux = eval_step(to_device(rows, device), sizes)
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
    """(source, train, val) datasets with GF's labels; the source (the
    DA recipes' virtual scenes, split ``train_aug``) is None for FSB and
    WSB. WSB jitters the training centres; BR and CenterRefine jitter both
    domains' (`backtoreality_tpu/train/groupfree.py:423-447`)."""
    kw = dict(num_points=flags.num_point, use_color=flags.use_color,
              use_height=flags.use_height, seed=flags.rng_seed,
              gf_labels=True, **common.cache_kw(flags))
    jitter = 0.0 if recipe == "fsb" else flags.center_jitter
    source_ds = None
    if recipe in ("br", "br_center_refine"):
        source_ds = DetectionDataset(cfg, flags.source_data_root,
                                     split="train_aug", augment=True,
                                     center_jitter=jitter, **kw)
    train_ds = DetectionDataset(
        cfg, flags.data_root, split=flags.train_split, augment=True,
        center_jitter=jitter, **kw)
    val_ds = DetectionDataset(
        cfg, flags.val_data_root or flags.data_root, split=flags.val_split,
        augment=False, **kw)
    return source_ds, train_ds, val_ds


def _restore(model, optimizer, flags, recipe, ckpt_path, logger):
    """Model (and with --resume optimizer) state from a checkpoint;
    returns the epoch to start at. --resume continues from the run's own
    last checkpoint, or --checkpoint_path if given. Without it,
    --checkpoint_path warm-starts the weights only: FSB and WSB need every
    entry (a checkpoint of another graph is refused); BR and CenterRefine
    graft what matches and keep the rest fresh, as the JAX package's
    partial restore does (BR's weights into CenterRefine's new heads)."""
    if flags.resume:
        src = flags.checkpoint_path or ckpt_path
        if not pathlib.Path(src).exists():
            logger.info("--resume: no checkpoint at %s, fresh start", src)
            return 0
        ckpt = common.load_checkpoint(src)
        model.load_state_dict(ckpt["model"])
        optimizer.load_state_dict(ckpt["optimizer"])
        logger.info("resumed %s (epoch %d)", src, ckpt["epoch"])
        return ckpt["epoch"] + 1
    if flags.checkpoint_path and recipe in ("fsb", "wsb"):
        common.restore_weights(model, flags.checkpoint_path, "GroupFree3D",
                               logger.info)
    elif flags.checkpoint_path:
        state, ckpt_epoch = common.load_weights(flags.checkpoint_path)
        common.partial_restore(model, state, log=logger.info)
        logger.info("grafted checkpoint %s (epoch %s)",
                    flags.checkpoint_path, ckpt_epoch)
    return 0


def _pairs(loader_S, loader_T):
    """The epoch's (source, target) batches: a cycle of the shorter loader
    zipped with the longer (`backtoreality_tpu/train/groupfree.py:571-575`);
    the loop stops after as many pairs as the shorter holds."""
    if len(loader_S) <= len(loader_T):
        return zip(cycle(loader_S), loader_T)
    return zip(loader_S, cycle(loader_T))


def main(recipe: str, argv=None):
    """Parse `argv` (default: the command line) and train `recipe`: fsb,
    wsb, br or br_center_refine. Returns the trained model and its
    optimizer; with ``--num_devices`` above 1, None (the ranks ran in
    processes of their own; the state is in the checkpoint)."""
    if recipe not in RECIPES:
        raise ValueError(f"unknown recipe {recipe!r}")
    common.make_deterministic()
    parser = argparse.ArgumentParser()
    add_flags(parser)
    if recipe != "fsb":
        parser.add_argument("--center_jitter", type=float, default=0.1)
    if recipe in ("br", "br_center_refine"):
        parser.add_argument("--source_data_root", required=True,
                            help="virtual-scene data root (obj_aug)")
    flags = parser.parse_args(argv)
    return common.launch(_train, flags, recipe)


def _train(flags, device, recipe):
    """The training loop of `recipe` on `device` (one rank of several
    when there is a process group). Returns the model and its
    optimizer."""
    da = recipe in ("br", "br_center_refine")
    jitter_model = recipe == "br_center_refine"
    split = parallel.world() > 1 and not flags.multihost
    shards = parallel.process_shard_info() if flags.multihost else (1, 0)
    shard_kw = dict(num_shards=shards[0], shard_index=shards[1])
    cfg = get_config(flags.dataset)
    logger = common.setup_logger(flags.log_dir, name="gf")
    common.dump_config(flags.log_dir, vars(flags))
    source_ds, train_ds, val_ds = _make_datasets(flags, cfg, recipe)
    train_loader = DetectionDataLoader(train_ds, flags.batch_size,
                                       seed=flags.rng_seed, **shard_kw)
    val_loader = DetectionDataLoader(val_ds, flags.batch_size,
                                     shuffle=False, drop_last=False,
                                     **shard_kw)
    loader_S = None
    if da:
        loader_S = DetectionDataLoader(source_ds, flags.batch_size,
                                       seed=flags.rng_seed + 1, **shard_kw)
        logger.info("S scans: %d, T scans: %d, val: %d", len(source_ds),
                    len(train_ds), len(val_ds))
        steps_per_epoch = min(len(loader_S), len(train_loader))
    else:
        logger.info("train scans: %d, val scans: %d", len(train_ds),
                    len(val_ds))
        steps_per_epoch = len(train_loader)

    torch.manual_seed(flags.rng_seed)
    kind = "da_jitter" if jitter_model else ("da" if da else "plain")
    model = build_model(flags, cfg, kind).to(device)
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
    start_epoch = _restore(model, optimizer, flags, recipe, ckpt_path,
                           logger)
    parallel.replicate(model)
    parallel.check_same(steps_per_epoch, "train steps an epoch")
    if parallel.rank():
        # each rank draws dropout masks of its own rows
        torch.manual_seed(flags.rng_seed + parallel.rank())
    history = ScalarHistory(flags.log_dir)

    if da:
        train_step = make_da_train_step(model, optimizer, cfg, loss_kw,
                                        jitter=jitter_model)
    else:
        train_step = make_train_step(model, optimizer, criterion, cfg,
                                     loss_kw)
    prefixes = eval_prefixes(flags)
    # the DA recipes evaluate with the weak criterion on the target
    eval_step = make_eval_step(model, criterion, cfg, loss_kw, prefixes,
                               jitter=jitter_model)
    recal_loader = (parallel.ShardedRows(train_loader) if split
                    else train_loader)

    def rows(batch):
        return parallel.shard_rows(batch)[0] if split else batch

    guard = common.PreemptionGuard(ckpt_path, logger)
    trace = TraceWindow(flags.profile_dir)
    timer = StepTimer()
    host_step = 0
    try:
        for epoch in range(start_epoch, flags.max_epoch):
            train_loader.set_epoch(epoch)
            timer.reset()
            if da:
                loader_S.set_epoch(epoch)
                batches = _pairs(loader_S, train_loader)
            else:
                batches = ((batch,) for batch in train_loader)
            aux_hist = []
            for pair in batches:
                host_step += 1
                trace.before(host_step)
                args = [to_device(rows(b), device) for b in pair]
                aux_hist.append(train_step(*args, flags.bn_momentum,
                                           *([epoch] if da else [])))
                trace.after(host_step)
                timer.tick(flags.batch_size)
                if (flags.guard_every_steps
                        and len(aux_hist) % flags.guard_every_steps == 0):
                    # saved as the epoch before: a resume re-runs this one
                    guard.update(model, optimizer, epoch - 1)
                if len(aux_hist) >= steps_per_epoch:
                    break
            means = common.fetch_aux_means(aux_hist)  # waits for the device
            lr = optimizer.param_groups[0]["lr"]  # the epoch's last step's
            logger.info("epoch %03d lr %.2e loss %.4f (%d batches, %.1fs, "
                        "%.2f scenes/s)", epoch, lr,
                        means.get("loss", float("nan")), timer.steps,
                        timer.elapsed, timer.scenes_per_sec)
            history.append(epoch, means, lr=lr,
                           scenes_per_sec=timer.scenes_per_sec)
            guard.update(model, optimizer, epoch)
            if (epoch + 1) % flags.save_freq == 0 or \
                    epoch == flags.max_epoch - 1:
                common.save_checkpoint(
                    pathlib.Path(flags.log_dir) / f"ckpt_epoch_{epoch}.tar",
                    model, optimizer, epoch)
            common.save_checkpoint(ckpt_path, model, optimizer, epoch)
            if (epoch + 1) % flags.val_freq == 0:
                # the (target's) train batches, as the JAX loop's
                with common.buffers_kept(model), \
                        recal_dropout(model) as seed:
                    common.recalibrate_bn(
                        recal_loader,
                        common.make_recal_step(model, jitter=jitter_model,
                                               before=seed),
                        device, common.recal_batches(flags))
                    results, _ = evaluate(val_loader, eval_step, cfg,
                                          device, logger, flags, prefixes,
                                          split)
                first = results[(prefixes[0], flags.ap_iou_thresholds[0])]
                history.append(epoch, {
                    "mAP": first["mAP"], "AR": first["AR"],
                    **{f"mAP@{t}": results[(prefixes[0], t)]["mAP"]
                       for t in flags.ap_iou_thresholds}}, kind="eval")
                if da and parallel.rank() == 0:
                    with open(pathlib.Path(flags.log_dir) / "Eval_mAP.txt",
                              "a") as f:
                        f.write(f"{epoch}\t{first['mAP']:.4f}\n")
    finally:
        trace.close()
        guard.close()
    return model, optimizer
