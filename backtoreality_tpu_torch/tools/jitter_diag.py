"""Does the CenterRefine jitter head recover the injected annotation
error?

Counterpart of ``backtoreality_tpu/tools/jitter_diag.py``. Loads a
trained CenterRefine checkpoint, forwards the scans of either domain in
eval mode, and compares `jitter_pred` against the known injected
`center_jitter` label (size * delta table) of every valid object. The
epoch-ramped label refinement (`detection/Votenet/models/loss_helper.py:
698-701`) only helps if this prediction correlates with the true error;
this tool measures exactly that.

Reports: mean |injected| (the error to undo), mean |injected - pred|
(residual after full refinement), mean |pred|, mean cosine, and the
recovered fraction 1 - residual/injected (negative = refinement adds
error).

The model is the ``da_jitter`` graph of the run's ``config.json`` (the
port's trainers and the JAX package's write one); the checkpoint is any
that ``train.common.load_weights`` reads (the JAX package's msgpack, the
port's training checkpoint or state_dict), partially restored as the
JAX tool restores it. It runs on the card unless ``--cpu`` is given.

Usage:
  python -m backtoreality_tpu_torch.tools.jitter_diag \
      --ckpt log/train_BR_CenterRefine.tar --config log/config.json \
      --data_root <target-or-source root> [--cpu]
"""

from __future__ import annotations

import argparse
import json
import types

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="CenterRefine checkpoint "
                         "(<log_dir>/train_BR_CenterRefine.tar, or a "
                         "reference torch CR checkpoint converted via "
                         "tools/torch_import.py). Regenerate the study "
                         "fixture with `parity_fixture --kind br`")
    ap.add_argument("--config", required=True,
                    help="the training run's <log_dir>/config.json")
    ap.add_argument("--data_root", required=True,
                    help="jittered-domain fixture root (the 'real' "
                         "part of the br fixture)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.train import common
    from backtoreality_tpu_torch.train.evaluate import build_model

    device = common.resolve_device("cpu" if args.cpu else None)
    with open(args.config) as f:
        flags = types.SimpleNamespace(**json.load(f))
    cfg = get_config(flags.dataset)
    model = build_model(flags, cfg, "da_jitter")

    ds = DetectionDataset(
        cfg, args.data_root, split="all", num_points=flags.num_point,
        use_color=flags.use_color, use_height=not flags.no_height,
        augment=False, center_jitter=flags.center_jitter)
    loader = DetectionDataLoader(ds, flags.batch_size, shuffle=False,
                                 drop_last=True)

    state, epoch = common.load_weights(args.ckpt)
    common.partial_restore(model, state)
    model.to(device).eval()
    print(f"loaded {args.ckpt} (epoch {epoch})")

    inj_n, res_n, pred_n, cos_sum, nobj = [], [], [], 0.0, 0
    for batch in loader:
        dev = common.to_device(batch, device)
        with torch.no_grad():
            pred = model(*common.model_args(dev, jitter=True))[
                "jitter_pred"].float().cpu().numpy()
        inj = batch["center_jitter"]           # (B, K, 3) true injected
        mask = batch["box_label_mask"].astype(bool)
        for b in range(inj.shape[0]):
            m = mask[b]
            if not m.any():
                continue
            i, p = inj[b][m], pred[b][m]
            inj_n += list(np.linalg.norm(i, axis=-1))
            res_n += list(np.linalg.norm(i - p, axis=-1))
            pred_n += list(np.linalg.norm(p, axis=-1))
            denom = (np.linalg.norm(i, axis=-1)
                     * np.linalg.norm(p, axis=-1) + 1e-9)
            cos_sum += float(((i * p).sum(-1) / denom).sum())
            nobj += int(m.sum())

    out = {
        "objects": nobj,
        "mean_injected_norm_m": round(float(np.mean(inj_n)), 4),
        "mean_residual_norm_m": round(float(np.mean(res_n)), 4),
        "mean_pred_norm_m": round(float(np.mean(pred_n)), 4),
        "mean_cosine(pred,injected)": round(cos_sum / max(nobj, 1), 4),
        "recovered_frac": round(
            1.0 - float(np.mean(res_n)) / float(np.mean(inj_n)), 4),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
