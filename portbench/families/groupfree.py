"""GroupFree3D: how the benchmark drives the system and the reference.

The system: ``train.groupfree.build_model`` at the configuration's flags;
training takes ``train.groupfree.make_train_step`` with
``losses.groupfree.get_loss`` and ``loss_kwargs(flags)``, and
``common.make_gf_optimizer`` (the clip, AdamW in two groups) with the
trainer's schedules at their first update; serving takes the model's
forward in eval mode, as ``evaluate.main`` calls it. Dropout: the
benchmark hands the system's decoder a generator seeded from the run's
seed (``set_dropout_generator``) and the reference one seeded alike, and
both draw their masks in the same order, so both sides drop the same
entries. The reference: ``portbench/reference/groupfree.py`` with the
plain criterion and AdamW."""

from __future__ import annotations

import argparse

import torch

from portbench import weights as bench_weights
from portbench.families import common
from portbench.reference import groupfree as ref_groupfree
from portbench.reference import losses as ref_losses
from portbench.reference import optim as ref_optim
from portbench.reference.nn import set_bn_momentum

SUFFIXES = ("center", "heading_scores", "heading_residuals", "size_scores",
            "size_residuals", "sem_cls_scores", "objectness_scores")
EVAL_KEYS = tuple("last_" + s for s in SUFFIXES)
DROPOUT_STREAM = 3


def _flags(config):
    from backtoreality_tpu_torch.train import groupfree

    parser = groupfree.add_flags(argparse.ArgumentParser())
    return parser.parse_args(common.argv(config["flags"]))


def _build(config):
    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.train import groupfree

    flags = _flags(config)
    cfg = get_config(flags.dataset)
    common.check_config(config, cfg)
    with torch.device("meta"):
        model = groupfree.build_model(flags, cfg, "plain")
    return model, flags, cfg


def shapes(config):
    model, _, _ = _build(config)
    return {k: v.shape for k, v in model.state_dict().items()}


def program_trainer(config, device, weights, seed):
    """(model, step(batch) -> aux, optimizer)."""
    from backtoreality_tpu_torch.losses import groupfree as gf_losses
    from backtoreality_tpu_torch.models.groupfree.transformer import \
        set_dropout_generator
    from backtoreality_tpu_torch.train import common as train_common
    from backtoreality_tpu_torch.train import groupfree

    model, flags, cfg = _build(config)
    model = common.load(model, device, weights)
    spe = config["train"]["steps_per_epoch"]
    lr_fn = train_common.make_gf_schedule(flags.learning_rate, flags, spe)
    decoder_lr_fn = train_common.make_gf_schedule(
        flags.decoder_learning_rate, flags, spe)
    optimizer = train_common.make_gf_optimizer(
        model, lr_fn, decoder_lr_fn, flags.weight_decay, flags.clip_norm)
    common.check_train(config, learning_rate=lr_fn(0),
                       decoder_learning_rate=decoder_lr_fn(0),
                       weight_decay=flags.weight_decay, clip=flags.clip_norm,
                       bn_momentum=flags.bn_momentum)
    loss_kw = groupfree.loss_kwargs(flags)
    for key, value in {**config["loss"], "center_loss_type": "smoothl1",
                       "size_loss_type": "smoothl1",
                       "heading_loss_type": "smoothl1"}.items():
        if loss_kw[key] != value:
            raise ValueError(f"loss {key}: the system takes {loss_kw[key]},"
                             f" the reference {value}")
    generator = bench_weights.generator(device, seed, DROPOUT_STREAM)
    set_dropout_generator(model, generator)
    step = groupfree.make_train_step(model, optimizer, gf_losses.get_loss,
                                     cfg, loss_kw)
    return (model, (lambda batch: step(batch, flags.bn_momentum)), optimizer,
            generator)


def program_server(config, device, weights):
    """(model, forward(point_clouds) -> outputs by EVAL_KEYS)."""
    model, _, _ = _build(config)
    model = common.load(model, device, weights)
    model.eval()

    def forward(points):
        ep = model(points)
        return {k: ep[k] for k in EVAL_KEYS}

    return model, forward


def reference_model(config, device, weights):
    with torch.device("meta"):
        model = ref_groupfree.build(config)
    return common.load(model, device, weights)


def reference_trainer(config, device, weights, seed):
    """The reference's train step (``portbench.reference.optim.Trainer``),
    its dropout drawn from a generator seeded as the system's."""
    model = reference_model(config, device, weights)
    train = config["train"]
    set_bn_momentum(model, train["bn_momentum"])
    generator = bench_weights.generator(device, seed, DROPOUT_STREAM)
    m = config["model"]

    def lr_of(name):
        top = name.split(".", 1)[0]
        return train["decoder_learning_rate" if top.startswith("decoder")
                     else "learning_rate"]

    def loss(batch):
        ep = {**batch, **model(batch["point_clouds"], generator)}
        return ref_losses.groupfree_loss(
            ep, config["mean_size_arr"], m["num_heading_bin"],
            m["num_size_cluster"], m["num_decoder_layers"],
            **config["loss"])[0]

    return ref_optim.Trainer(model, loss, lr_of,
                             weight_decay=train["weight_decay"],
                             clip=train["clip"], generator=generator)


def reference_server(config, device, weights):
    model = reference_model(config, device, weights)
    model.eval()

    def forward(points):
        ep = model(points)
        return {k: ep[k] for k in EVAL_KEYS}

    return forward
