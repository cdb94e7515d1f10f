"""VoteNet: how the benchmark drives the system and the reference.

The system: ``train.evaluate.build_model`` at the configuration's flags;
training takes ``train.votenet.make_train_step`` with
``losses.votenet.get_loss`` and ``common.make_optimizer(..., "adam")``
at the trainer's epoch-0 learning rate and BN momentum; serving takes the
model's forward in eval mode, as ``evaluate.main`` calls it. The
reference: ``portbench/reference/votenet.py`` with the plain criterion and
Adam."""

from __future__ import annotations

import argparse

import torch

from portbench.families import common
from portbench.reference import losses as ref_losses
from portbench.reference import optim as ref_optim
from portbench.reference import votenet as ref_votenet
from portbench.reference.nn import set_bn_momentum

EVAL_KEYS = ("center", "heading_scores", "heading_residuals", "size_scores",
             "size_residuals", "sem_cls_scores", "objectness_scores")


def _flags(config):
    from backtoreality_tpu_torch.train import votenet

    parser = votenet.add_common_flags(argparse.ArgumentParser())
    return parser.parse_args(common.argv(config["flags"]))


def _build(config):
    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.train import evaluate

    flags = _flags(config)
    cfg = get_config(flags.dataset)
    common.check_config(config, cfg)
    with torch.device("meta"):
        model = evaluate.build_model(flags, cfg, "plain")
    return model, flags, cfg


def shapes(config):
    model, _, _ = _build(config)
    return {k: v.shape for k, v in model.state_dict().items()}


def program_trainer(config, device, weights, seed):
    """(model, step(batch) -> aux, optimizer)."""
    from backtoreality_tpu_torch.losses import votenet as vote_losses
    from backtoreality_tpu_torch.train import common as train_common
    from backtoreality_tpu_torch.train import votenet

    model, flags, cfg = _build(config)
    model = common.load(model, device, weights)
    optimizer = train_common.make_optimizer(
        model.parameters(), "adam", flags.weight_decay,
        lr0=flags.learning_rate)
    step = votenet.make_train_step(model, optimizer, vote_losses.get_loss,
                                   cfg)
    bn_momentum = train_common.bn_momentum_fn(
        step=flags.bn_decay_step, rate=flags.bn_decay_rate)(0)
    common.check_train(config, learning_rate=flags.learning_rate,
                       weight_decay=flags.weight_decay,
                       bn_momentum=bn_momentum)
    return model, (lambda batch: step(batch, bn_momentum)), optimizer, None


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
        model = ref_votenet.build(config)
    return common.load(model, device, weights)


def reference_trainer(config, device, weights, seed):
    """The reference's train step (``portbench.reference.optim.Trainer``)."""
    model = reference_model(config, device, weights)
    train = config["train"]
    set_bn_momentum(model, train["bn_momentum"])
    m = config["model"]

    def loss(batch):
        ep = {**batch, **model(batch["point_clouds"])}
        return ref_losses.votenet_loss(ep, config["mean_size_arr"],
                                       m["num_heading_bin"],
                                       m["num_size_cluster"])[0]

    return ref_optim.Trainer(model, loss, lambda name: train["learning_rate"])


def reference_server(config, device, weights):
    model = reference_model(config, device, weights)
    model.eval()

    def forward(points):
        ep = model(points)
        return {k: ep[k] for k in EVAL_KEYS}

    return forward
