"""GF subset-FPS quality sweep: exact FPS against --fps_candidates K,
several seeds each, in one process.

Counterpart of ``backtoreality_tpu/tools/gf_sweep.py``. It settles
whether GroupFree3D trained with subset FPS at SA1 scores as with exact
FPS (the JAX package's round-2 question: exact 0.5195 against K=8192
0.4736 mAP@0.25, one run each): with 3 or more seeds an arm, the gap is
either real or run variance. Each run trains ``gf_fsb``'s step from a
fresh model and optimizer for ``--max_epoch`` epochs and evaluates the
last decoder head once; one JSON line a run goes to
``<out>/sweep.jsonl``, the exact arm first (``fps_candidates`` null).

The JAX tool reuses one compiled step per arm across its seeds; PyTorch
compiles nothing, so here each seed simply builds its model and
optimizer afresh. The flags are ``train.groupfree.add_flags``'s, with
the learning rate decayed at 0.7 and 0.87 of ``--max_epoch``; the
schedules, AdamW groups, clip and evaluation are the port's GF trainer's.
It runs on the card unless ``--device cpu`` is given.

Usage:
  python -m backtoreality_tpu_torch.tools.gf_sweep --data_root D/train \
      --val_data_root D/val --out sweep_out --seeds 0 1 2 \
      --candidates 8192 --max_epoch 300
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch


def run_config(flags, fps_candidates, seeds, out_path, logger):
    """Train and evaluate GF at `fps_candidates` (None: exact FPS) once a
    seed of `seeds`, appending each run's line to `out_path`; returns the
    lines."""
    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.losses import groupfree as gf_losses
    from backtoreality_tpu_torch.train import common
    from backtoreality_tpu_torch.train import groupfree as gf

    cfg = get_config(flags.dataset)
    device = common.resolve_device(flags.device)
    flags.fps_candidates = fps_candidates
    loss_kw = gf.loss_kwargs(flags)
    prefixes = ("last_",)

    train_ds = DetectionDataset(
        cfg, flags.data_root, split="all", num_points=flags.num_point,
        use_height=flags.use_height, augment=True, gf_labels=True,
        seed=0)
    val_ds = DetectionDataset(
        cfg, flags.val_data_root, split="all",
        num_points=flags.num_point, use_height=flags.use_height,
        augment=False, gf_labels=True, seed=0)
    steps_per_epoch = len(train_ds) // flags.batch_size

    results = []
    for seed in seeds:
        torch.manual_seed(seed)
        model = gf.build_model(flags, cfg).to(device)
        optimizer = common.make_gf_optimizer(
            model,
            common.make_gf_schedule(flags.learning_rate, flags,
                                    steps_per_epoch),
            common.make_gf_schedule(flags.decoder_learning_rate, flags,
                                    steps_per_epoch),
            flags.weight_decay, flags.clip_norm)
        train_step = gf.make_train_step(model, optimizer, gf_losses.get_loss,
                                        cfg, loss_kw)
        eval_step = gf.make_eval_step(model, gf_losses.get_loss, cfg,
                                      loss_kw, prefixes)
        train_loader = DetectionDataLoader(train_ds, flags.batch_size,
                                           seed=seed)
        val_loader = DetectionDataLoader(val_ds, flags.batch_size,
                                         shuffle=False, drop_last=False)

        t0 = time.time()
        for epoch in range(flags.max_epoch):
            train_loader.set_epoch(epoch)
            aux_hist = [train_step(common.to_device(batch, device),
                                   flags.bn_momentum)
                        for batch in train_loader]
            if (epoch + 1) % 100 == 0:
                means = common.fetch_aux_means(aux_hist)
                logger(f"cand={fps_candidates} seed={seed} "
                       f"epoch={epoch} loss={means.get('loss'):.4f} "
                       f"({time.time() - t0:.0f}s)")
        metrics, _ = gf.evaluate(val_loader, eval_step, cfg, device, None,
                                 flags, prefixes)
        rec = {
            "fps_candidates": fps_candidates,
            "seed": seed,
            "mAP@0.25": float(metrics[("last_", 0.25)]["mAP"]),
            "AR@0.25": float(metrics[("last_", 0.25)]["AR"]),
            "mAP@0.50": float(metrics[("last_", 0.5)]["mAP"]),
            "AR@0.50": float(metrics[("last_", 0.5)]["AR"]),
            "train_secs": round(time.time() - t0, 1),
        }
        logger(json.dumps(rec))
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        results.append(rec)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--val_data_root", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=[0, 1, 2])
    parser.add_argument("--candidates", type=int, nargs="+",
                        default=[8192],
                        help="subset-FPS K arms (exact FPS always runs)")
    parser.add_argument("--skip_exact", action="store_true")
    parser.add_argument("--max_epoch", type=int, default=300)
    parser.add_argument("--num_point", type=int, default=20000)
    parser.add_argument("--num_target", type=int, default=256)
    parser.add_argument("--num_decoder_layers", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; pass cpu to run"
                             " on the CPU)")
    args = parser.parse_args(argv)

    from backtoreality_tpu_torch.train import common
    from backtoreality_tpu_torch.train import groupfree as gf

    # as every entry point: the steps are the ones users run
    common.make_deterministic()
    # the trainer's default flags, overridden by the sweep's
    dflags = argparse.ArgumentParser()
    gf.add_flags(dflags)
    flags = dflags.parse_args([
        "--data_root", args.data_root,
        "--num_point", str(args.num_point),
        "--num_target", str(args.num_target),
        "--num_decoder_layers", str(args.num_decoder_layers),
        "--batch_size", str(args.batch_size),
        "--max_epoch", str(args.max_epoch),
        "--lr_decay_epochs",
        str(int(args.max_epoch * 0.7)), str(int(args.max_epoch * 0.87)),
    ])
    flags.val_data_root = args.val_data_root
    flags.device = args.device

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / "sweep.jsonl"

    def logger(msg):
        print(msg, flush=True)

    arms = ([] if args.skip_exact else [None]) + list(args.candidates)
    for cand in arms:
        run_config(flags, cand, args.seeds, out_path, logger)


if __name__ == "__main__":
    main()
