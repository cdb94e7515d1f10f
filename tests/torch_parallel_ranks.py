"""Rank jobs for the port's data-parallel tests, run in spawned processes
over gloo on the CPU. Imports nothing of JAX: a rank starts from a fresh
interpreter and reads its inputs from a file the test wrote.

`enter` is the process function for ``train.common.spawn``: it joins
the group and runs ``job(*args)``. `sleep` and `exit_on_rank_one` are
process functions for the tests of ``spawn`` itself."""

from __future__ import annotations

import sys
import time

import torch

from backtoreality_tpu_torch import parallel


def enter(rank, world, address, job, args):
    torch.set_num_threads(2)
    parallel.init(rank, world, address, torch.device("cpu"), world)
    try:
        job(*args)
    finally:
        parallel.shutdown()


def sleep(rank, world, address, seconds):
    time.sleep(seconds)


def exit_on_rank_one(rank, world, address, code):
    """Rank 1 exits with `code` at once; rank 0 would wait a minute."""
    if rank == 1:
        sys.exit(code)
    time.sleep(60)


def _numpy(tree):
    if torch.is_tensor(tree):
        return tree.detach().numpy().copy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _rows(batch):
    """This rank's rows of a numpy batch, as tensors."""
    rows, _ = parallel.shard_rows(batch)
    return {k: torch.from_numpy(v) for k, v in rows.items()}


def bn_case(inp):
    """BatchNorm in train mode on this rank's rows of `bn_x`: the output
    rows, the input's gradient, the summed parameter gradients and the
    running statistics."""
    from backtoreality_tpu_torch.nn import BatchNorm

    bn = BatchNorm(inp["bn_x"].shape[-1]).double()
    bn.momentum = 0.1
    x = _rows({"x": inp["bn_x"]})["x"].requires_grad_()
    y = bn(x)
    w = _rows({"w": inp["bn_w"]})["w"]
    (y * w).sum().backward()
    parallel.all_reduce_grads(bn.parameters())
    return dict(y=y, x_grad=x.grad, weight_grad=bn.weight.grad,
                bias_grad=bn.bias.grad, running_mean=bn.running_mean,
                running_var=bn.running_var)


def votenet_fsb_case(inp):
    """One VoteNet FSB step (SGD at lr 0: the parameters stay, the
    gradients and BN statistics are the step's)."""
    from backtoreality_tpu_torch.losses import votenet as losses
    from backtoreality_tpu_torch.models.votenet import VoteNet
    from backtoreality_tpu_torch.train import votenet

    model = VoteNet(mean_size_arr=inp["mean_size_arr"], **inp["vn_kw"])
    model.load_state_dict(inp["vn_state"])
    model.double()
    step = votenet.make_train_step(
        model, torch.optim.SGD(model.parameters(), lr=0.0),
        inp.get("criterion", losses.get_loss), inp["cfg"])
    aux = step(_rows(inp["fsb_batch"]), inp["bn_momentum"])
    return dict(aux=aux, grads=_grads(model),
                buffers=dict(model.named_buffers()))


def votenet_br_case(inp):
    """One BR step (source then target forward, `get_loss_DA`)."""
    from backtoreality_tpu_torch.models.votenet import VoteNetDA
    from backtoreality_tpu_torch.train import votenet

    model = VoteNetDA(mean_size_arr=inp["mean_size_arr"], **inp["vn_kw"])
    model.load_state_dict(inp["br_state"])
    model.double()
    step = votenet.make_da_train_step(
        model, torch.optim.SGD(model.parameters(), lr=0.0), inp["cfg"])
    aux = step(_rows(inp["br_S"]), _rows(inp["br_T"]), inp["bn_momentum"],
               0)
    return dict(aux=aux, grads=_grads(model),
                buffers=dict(model.named_buffers()))


def gf_fsb_case(inp):
    """One GroupFree3D FSB step, dropout 0, through GF's optimizer at
    learning rate 0: the gradients it leaves are the clipped ones."""
    from backtoreality_tpu_torch.losses import groupfree as losses
    from backtoreality_tpu_torch.models.groupfree import GroupFreeDetector
    from backtoreality_tpu_torch.train import common, groupfree

    model = GroupFreeDetector(mean_size_arr=inp["mean_size_arr"],
                              dropout_rate=0.0, **inp["gf_kw"])
    model.load_state_dict(inp["gf_state"])
    model.double()
    opt = common.make_gf_optimizer(model, lambda count: 0.0,
                                   lambda count: 0.0, 5e-4, inp["clip"])
    step = groupfree.make_train_step(model, opt, losses.get_loss,
                                     inp["cfg"], inp["gf_loss_kw"])
    aux = step(_rows(inp["gf_batch"]), inp["bn_momentum"])
    return dict(aux=aux, grads=_grads(model),
                buffers=dict(model.named_buffers()))


def eval_case(inp):
    """VoteNet's evaluation at fixed weights, every rank running its rows
    of each batch (``--num_devices``): the mAP, AR and eval loss means."""
    from backtoreality_tpu_torch.losses import votenet as losses
    from backtoreality_tpu_torch.models.votenet import VoteNet
    from backtoreality_tpu_torch.train import votenet

    model = VoteNet(mean_size_arr=inp["mean_size_arr"], **inp["vn_kw"])
    model.load_state_dict(inp["vn_state"])
    model.double()
    eval_step = votenet.make_eval_step(model, losses.get_loss, inp["cfg"])
    metrics, means = votenet.evaluate(inp["val_batches"], eval_step,
                                      inp["cfg"], "cpu", None, split=True)
    return dict(mAP=metrics["mAP"], AR=metrics["AR"], means=means)


CASES = {"bn": bn_case, "votenet_fsb": votenet_fsb_case,
         "votenet_br": votenet_br_case, "gf_fsb": gf_fsb_case,
         "eval": eval_case}


def step_job(inputs_path, out_dir, cases):
    """Every case of `cases` on this rank; writes ``rank{r}.pt`` (numpy)."""
    inp = torch.load(inputs_path, weights_only=False)
    out = {name: _numpy(CASES[name](inp)) for name in cases}
    torch.save(out, f"{out_dir}/rank{parallel.rank()}.pt")
