"""Import reference PyTorch checkpoints into the port.

A user of the reference repo (`wyf-ACCEPT/BackToReality`) converts a
torch checkpoint it trained into a ``torch.save`` of the port's
state_dict, then evaluates or trains on from it:

    python -m backtoreality_tpu_torch.tools.torch_import \
        checkpoint.tar --model votenet --out votenet.pt
    python -m backtoreality_tpu_torch.train.evaluate --model votenet \
        --checkpoint_path votenet.pt --query_mode exact --data_root D

Counterpart of ``backtoreality_tpu/tools/torch_import.py``, whose numpy
converters this module copies verbatim (`:47-396`; four docstrings say
"JAX" where the originals name its neural-network library): they map the
reference's tensors onto the JAX package's variables tree, which
`bridge.state_dict_from_jax` then maps strictly onto the port's names.
It reads both reference layouts — VoteNet's training scripts save
``{'model_state_dict': ...}`` (`train_Votenet_FSB.py:309-318`), GF saves
``{'model': ...}`` (`train_GF_FSB.py:121-144`) — plus raw state_dicts and
`nn.DataParallel`'s ``module.`` prefixes, from a plain (not gzipped)
torch file, read with ``weights_only=True``: tensors and plain values,
which is all the reference writes, and nothing that unpickling could run.

Weight-mapping notes:

* torch ``Conv1d/2d`` (1x1) kernels transpose into channels-last Dense
  kernels (and back into the port's ``nn.Linear`` weights);
* the reference's pre-BN conv biases have no Dense counterpart (BatchNorm
  removes constant shifts); they fold EXACTLY into the BN running mean:
  ``BN(Wx + b; m, v) == BN(Wx; m - b, v)``;
* the vendored torch ``MultiheadAttention`` in/out projections go
  through the JAX package's (heads, head_dim) layout and back.

The converted file holds weights and running statistics only: load it
with ``--checkpoint_path`` (weights, grafting), not ``--resume``.
Reference-trained weights expect the reference's first-k grouping:
evaluate and fine-tune them with ``--query_mode exact``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from backtoreality_tpu_torch import bridge


# ---------------------------------------------------------------------------
# Shared low-level converters
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else \
        np.asarray(t)


def _shared_mlp(sd, prefix, layers):
    """Reference `pt_utils.SharedMLP` -> our SharedMLP tree."""
    params, stats = {}, {}
    for i in range(layers):
        w = _np(sd[f"{prefix}.layer{i}.conv.weight"])  # (Co, Ci, 1, 1)
        params[f"dense{i}"] = {
            "kernel": np.transpose(w[:, :, 0, 0], (1, 0))}
        params[f"bn{i}"] = {
            "scale": _np(sd[f"{prefix}.layer{i}.bn.bn.weight"]),
            "bias": _np(sd[f"{prefix}.layer{i}.bn.bn.bias"])}
        stats[f"bn{i}"] = {
            "mean": _np(sd[f"{prefix}.layer{i}.bn.bn.running_mean"]),
            "var": _np(sd[f"{prefix}.layer{i}.bn.bn.running_var"])}
    return {"mlp": params}, {"mlp": stats}


def _conv1d(sd, name):
    w = _np(sd[f"{name}.weight"])  # (Co, Ci, 1)
    out = {"kernel": np.transpose(w[:, :, 0], (1, 0))}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def _convbn_head(sd, prefix, nlayers=2):
    """Reference convK/bnK stacks + final conv (VoteNet vgen/pnet
    heads) -> dense{i}/bn{i} + out; pre-BN conv bias folds into the BN
    running mean."""
    params, stats = {}, {}
    for i in range(nlayers):
        w = _np(sd[f"{prefix}.conv{i + 1}.weight"])
        params[f"dense{i}"] = {
            "kernel": np.transpose(w[:, :, 0], (1, 0))}
        params[f"bn{i}"] = {
            "scale": _np(sd[f"{prefix}.bn{i + 1}.weight"]),
            "bias": _np(sd[f"{prefix}.bn{i + 1}.bias"])}
        conv_bias = _np(sd[f"{prefix}.conv{i + 1}.bias"])
        stats[f"bn{i}"] = {
            "mean": _np(sd[f"{prefix}.bn{i + 1}.running_mean"])
            - conv_bias,
            "var": _np(sd[f"{prefix}.bn{i + 1}.running_var"])}
    w = _np(sd[f"{prefix}.conv{nlayers + 1}.weight"])
    params["out"] = {
        "kernel": np.transpose(w[:, :, 0], (1, 0)),
        "bias": _np(sd[f"{prefix}.conv{nlayers + 1}.bias"])}
    return params, stats


def _convbn_stack(sd, convs, bns):
    """Plain torch Conv1d+BN1d stacks -> dense{i}/bn{i} (bias folds
    into the BN running mean)."""
    params, stats = {}, {}
    for i, (c, bnm) in enumerate(zip(convs, bns)):
        d = _conv1d(sd, c)
        conv_bias = d.pop("bias", 0.0)
        params[f"dense{i}"] = d
        params[f"bn{i}"] = {
            "scale": _np(sd[f"{bnm}.weight"]),
            "bias": _np(sd[f"{bnm}.bias"])}
        stats[f"bn{i}"] = {
            "mean": _np(sd[f"{bnm}.running_mean"]) - conv_bias,
            "var": _np(sd[f"{bnm}.running_var"])}
    return params, stats


# ---------------------------------------------------------------------------
# VoteNet
# ---------------------------------------------------------------------------


def votenet_state_dict(sd):
    """Reference VoteNet state_dict -> (JAX params, batch_stats)."""
    params = {"backbone_net": {}, "vgen": {}, "pnet": {}}
    stats = {"backbone_net": {}, "vgen": {}, "pnet": {}}
    for sa in ("sa1", "sa2", "sa3", "sa4"):
        p, s = _shared_mlp(sd, f"backbone_net.{sa}.mlp_module", 3)
        params["backbone_net"][sa] = p
        stats["backbone_net"][sa] = s
    for fp in ("fp1", "fp2"):
        p, s = _shared_mlp(sd, f"backbone_net.{fp}.mlp", 2)
        params["backbone_net"][fp] = p
        stats["backbone_net"][fp] = s

    p, s = _convbn_head(sd, "vgen")
    params["vgen"], stats["vgen"] = p, s

    p, s = _shared_mlp(sd, "pnet.vote_aggregation.mlp_module", 3)
    params["pnet"]["vote_aggregation"] = p
    stats["pnet"]["vote_aggregation"] = s
    p, s = _convbn_head(sd, "pnet")
    params["pnet"].update(p)
    stats["pnet"].update(s)
    return params, stats


def _convbn_stack_with_out(sd, convs, bns, out_conv):
    """_convbn_stack + a final biased 1x1 conv -> the _ConvBNStack
    `out` layer."""
    params, stats = _convbn_stack(sd, convs, bns)
    params["out"] = _conv1d(sd, out_conv)
    return params, stats


def votenet_da_state_dict(sd):
    """Reference `VoteNet_DA` state_dict (`votenet_DA.py:47-176`, the
    BR-stage model) -> (JAX params, batch_stats) for
    models.votenet.VoteNetDA: the plain VoteNet tree plus the
    global/local domain discriminators (`votenet_DA.py:90-120`)."""
    params, stats = votenet_state_dict(sd)
    p, s = _convbn_stack(sd, ["global_netD1.0", "global_netD1.3"],
                         ["global_netD1.1", "global_netD1.4"])
    params["da_heads"] = {"global_netD1": p,
                          "global_netD2": _dense(sd, "global_netD2")}
    stats["da_heads"] = {"global_netD1": s}
    p, s = _convbn_stack_with_out(
        sd, ["local_netD.0", "local_netD.3"],
        ["local_netD.1", "local_netD.4"], "local_netD.6")
    params["da_heads"]["local_netD"] = p
    stats["da_heads"]["local_netD"] = s
    return params, stats


def votenet_da_jitter_state_dict(sd):
    """Reference `VoteNet_DA_jitter` state_dict
    (`votenet_DA.py:179-332`) -> (JAX params, batch_stats) for
    models.votenet.VoteNetDAJitter: the plain VoteNet tree nested
    under backbone_net.backbone, plus the ctjt center-grouping head,
    the global/local domain discriminators, and the jitter nets."""
    core_p, core_s = votenet_state_dict(sd)
    params = {
        "backbone_net": {"backbone": core_p.pop("backbone_net")},
        **core_p,
    }
    stats = {
        "backbone_net": {"backbone": core_s.pop("backbone_net")},
        **core_s,
    }
    # ctjt head (`backbone_module.py:187-195`: PointnetSAModuleCenters
    # mlp [256(+3 xyz), 128] -> ONE SharedMLP layer)
    p, s = _shared_mlp(sd, "backbone_net.ctjt_head.mlp_module", 1)
    params["backbone_net"]["ctjt"] = p
    stats["backbone_net"]["ctjt"] = s
    # domain discriminators (`votenet_DA.py:223-253`)
    p, s = _convbn_stack(sd, ["global_netD1.0", "global_netD1.3"],
                         ["global_netD1.1", "global_netD1.4"])
    params["da_heads"] = {"global_netD1": p,
                          "global_netD2": _dense(sd, "global_netD2")}
    stats["da_heads"] = {"global_netD1": s}
    p, s = _convbn_stack_with_out(
        sd, ["local_netD.0", "local_netD.3"],
        ["local_netD.1", "local_netD.4"], "local_netD.6")
    params["da_heads"]["local_netD"] = p
    stats["da_heads"]["local_netD"] = s
    # jitter discriminator + prediction net (`votenet_DA.py:256-271`)
    p, s = _convbn_stack_with_out(
        sd, ["jitter_netD.0", "jitter_netD.3"],
        ["jitter_netD.1", "jitter_netD.4"], "jitter_netD.6")
    params["jitter_netD"] = p
    stats["jitter_netD"] = s
    p, s = _convbn_stack_with_out(sd, ["jitter_net.0"],
                                  ["jitter_net.1"], "jitter_net.3")
    params["jitter_net"] = p
    stats["jitter_net"] = s
    return params, stats


# ---------------------------------------------------------------------------
# GroupFree3D
# ---------------------------------------------------------------------------


def _mha(sd, prefix, nhead, d_model):
    """Vendored torch MultiheadAttention -> the JAX package's MHA params."""
    hd = d_model // nhead
    inw = _np(sd[f"{prefix}.in_proj_weight"])  # (3D, D)
    inb = _np(sd[f"{prefix}.in_proj_bias"])
    out = {}
    for i, name in enumerate(("query", "key", "value")):
        w = inw[i * d_model:(i + 1) * d_model]  # (D, D), y = W x
        out[name] = {
            "kernel": np.transpose(w, (1, 0)).reshape(
                d_model, nhead, hd),
            "bias": inb[i * d_model:(i + 1) * d_model].reshape(
                nhead, hd)}
    ow = _np(sd[f"{prefix}.out_proj.weight"])  # (D, D)
    out["out"] = {
        "kernel": np.transpose(ow, (1, 0)).reshape(nhead, hd, d_model),
        "bias": _np(sd[f"{prefix}.out_proj.bias"])}
    return out


def _layernorm(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _dense(sd, prefix):
    return {"kernel": np.transpose(_np(sd[f"{prefix}.weight"]), (1, 0)),
            "bias": _np(sd[f"{prefix}.bias"])}


def _posembed(sd, prefix):
    d = _conv1d(sd, f"{prefix}.position_embedding_head.0")
    conv_bias = d.pop("bias", 0.0)
    params = {"dense0": d}
    params["bn0"] = {
        "scale": _np(sd[f"{prefix}.position_embedding_head.1.weight"]),
        "bias": _np(sd[f"{prefix}.position_embedding_head.1.bias"])}
    stats = {"bn0": {
        "mean": _np(
            sd[f"{prefix}.position_embedding_head.1.running_mean"])
        - conv_bias,
        "var": _np(
            sd[f"{prefix}.position_embedding_head.1.running_var"])}}
    params["dense1"] = _conv1d(sd,
                               f"{prefix}.position_embedding_head.3")
    return params, stats


def _predict_head(sd, prefix):
    params, stats = _convbn_stack(
        sd, [f"{prefix}.conv1", f"{prefix}.conv2"],
        [f"{prefix}.bn1", f"{prefix}.bn2"])
    heads = {
        "objectness": "objectness_scores_head",
        "center_residual": "center_residual_head",
        "heading_class": "heading_class_head",
        "heading_residual": "heading_residual_head",
        "size_class": "size_class_head",
        "size_residual": "size_residual_head",
        "sem_cls": "sem_cls_scores_head",
    }
    for ours, theirs in heads.items():
        params[ours] = _conv1d(sd, f"{prefix}.{theirs}")
    return params, stats


def _gf_num_layers(sd):
    i = 0
    while any(k.startswith(f"decoder.{i}.") for k in sd):
        i += 1
    return i


def groupfree_state_dict(sd, nhead=8, d_model=288, num_layers=None):
    """Reference GroupFreeDetector state_dict -> (params, batch_stats).

    `num_layers` defaults to the decoder depth found in the state_dict.
    """
    if num_layers is None:
        num_layers = _gf_num_layers(sd)
    params = {"backbone_net": {}}
    stats = {"backbone_net": {}}
    for sa in ("sa1", "sa2", "sa3", "sa4"):
        p, s = _shared_mlp(sd, f"backbone_net.{sa}.mlp_module", 3)
        params["backbone_net"][sa] = p
        stats["backbone_net"][sa] = s
    for fp in ("fp1", "fp2"):
        p, s = _shared_mlp(sd, f"backbone_net.{fp}.mlp", 2)
        params["backbone_net"][fp] = p
        stats["backbone_net"][fp] = s

    if "points_obj_cls.conv1.weight" in sd:
        p, s = _convbn_stack(sd, ["points_obj_cls.conv1",
                                  "points_obj_cls.conv2"],
                             ["points_obj_cls.bn1",
                              "points_obj_cls.bn2"])
        p["out"] = _conv1d(sd, "points_obj_cls.conv3")
        params["points_obj_cls"] = p
        stats["points_obj_cls"] = s

    p, s = _predict_head(sd, "proposal_head")
    params["proposal_head"] = p
    stats["proposal_head"] = s

    if num_layers > 0:
        params["decoder_key_proj"] = _conv1d(sd, "decoder_key_proj")
        params["decoder_query_proj"] = _conv1d(sd, "decoder_query_proj")

    for i in range(num_layers):
        layer = {}
        layer["self_attn"] = _mha(sd, f"decoder.{i}.self_attn", nhead,
                                  d_model)
        layer["cross_attn"] = _mha(sd, f"decoder.{i}.multihead_attn",
                                   nhead, d_model)
        layer["linear1"] = _dense(sd, f"decoder.{i}.linear1")
        layer["linear2"] = _dense(sd, f"decoder.{i}.linear2")
        for nrm in ("norm1", "norm2", "norm3"):
            layer[nrm] = _layernorm(sd, f"decoder.{i}.{nrm}")
        params[f"decoder_{i}"] = layer

        p, s = _posembed(sd, f"decoder_self_posembeds.{i}")
        params[f"decoder_self_posembeds_{i}"] = p
        stats[f"decoder_self_posembeds_{i}"] = s
        p, s = _posembed(sd, f"decoder_cross_posembeds.{i}")
        params[f"decoder_cross_posembeds_{i}"] = p
        stats[f"decoder_cross_posembeds_{i}"] = s

        p, s = _predict_head(sd, f"prediction_heads.{i}")
        params[f"prediction_heads_{i}"] = p
        stats[f"prediction_heads_{i}"] = s
    return params, stats


def groupfree_da_state_dict(sd, nhead=8):
    """Reference `GroupFreeDetector_DA` state_dict
    (`detector_DA.py:56-185`, the GF BR-stage model) -> (params,
    batch_stats) for models.groupfree.da: the plain GF tree plus the
    global/decoder-local domain discriminators
    (`detector_DA.py:169-189`)."""
    params, stats = groupfree_state_dict(sd, nhead=nhead)
    p, s = _convbn_stack(sd, ["global_netD1.0", "global_netD1.3"],
                         ["global_netD1.1", "global_netD1.4"])
    params["da_heads"] = {"global_netD1": p,
                          "global_netD2": _dense(sd, "global_netD2")}
    stats["da_heads"] = {"global_netD1": s}
    p, s = _convbn_stack_with_out(
        sd, ["decoder_netD.0", "decoder_netD.3"],
        ["decoder_netD.1", "decoder_netD.4"], "decoder_netD.6")
    params["da_heads"]["decoder_netD"] = p
    stats["da_heads"]["decoder_netD"] = s
    return params, stats


# ---------------------------------------------------------------------------
# Checkpoint-level import
# ---------------------------------------------------------------------------


def extract_state_dict(payload):
    """Reference checkpoint layouts -> flat state_dict, epoch."""
    epoch = 0
    sd = payload
    if isinstance(payload, dict):
        if "model_state_dict" in payload:  # VoteNet trainers
            sd = payload["model_state_dict"]
            epoch = int(payload.get("epoch", 0) or 0)
        elif "model" in payload:  # GF save_checkpoint
            sd = payload["model"]
            ep = payload.get("epoch", 0)
            epoch = int(ep) if isinstance(ep, int) else 0
    # nn.DataParallel prefix
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    return sd, epoch


CONVERTERS = {
    "votenet": votenet_state_dict,
    "votenet_da": votenet_da_state_dict,
    "votenet_da_jitter": votenet_da_jitter_state_dict,
    "groupfree": groupfree_state_dict,
    "groupfree_da": groupfree_da_state_dict,
}


def convert(payload, model: str, nhead=8):
    """A loaded reference checkpoint -> (the port's state_dict, the count
    of parameter tensors, epoch)."""
    sd, epoch = extract_state_dict(payload)
    if model not in CONVERTERS:
        raise ValueError(f"unknown model {model!r}")
    kw = {"nhead": nhead} if model.startswith("groupfree") else {}
    params, stats = CONVERTERS[model](sd, **kw)
    state = bridge.state_dict_from_jax({"params": params,
                                        "batch_stats": stats})
    return state, sum(1 for _ in _iter_leaves(params)), epoch


def import_checkpoint(path, model: str, out, nhead=8):
    """torch checkpoint file of the reference -> ``torch.save`` of the
    port's state_dict at `out`. Returns (parameter tensors, epoch)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    try:
        state, nleaves, epoch = convert(payload, model, nhead)
    except KeyError as e:
        raise SystemExit(
            f"error: {path} does not look like a {model} checkpoint "
            f"(missing tensor {e}); did you mean the other --model?")
    torch.save(state, out)
    return nleaves, epoch


def _iter_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_leaves(v)
    else:
        yield tree


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert a reference torch checkpoint to the port's"
                    " state_dict")
    parser.add_argument("checkpoint", help="torch .tar/.pth file")
    parser.add_argument("--model", required=True, choices=list(CONVERTERS))
    parser.add_argument("--out", required=True)
    parser.add_argument("--nhead", type=int, default=8)
    args = parser.parse_args(argv)
    nleaves, epoch = import_checkpoint(args.checkpoint, args.model,
                                       args.out, nhead=args.nhead)
    print(f"imported {nleaves} parameter tensors (epoch {epoch}) "
          f"-> {args.out}")
    print("note: reference-TRAINED checkpoints expect the CUDA "
          "first-k grouping; evaluate/fine-tune with "
          "--query_mode exact.")
    return nleaves, epoch


if __name__ == "__main__":
    main()
