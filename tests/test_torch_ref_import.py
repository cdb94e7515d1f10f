"""The port's tools for reference checkpoints and the parity studies
against the JAX package's, on the CPU.

* `tools.torch_import` gives tensors exactly equal to the JAX importer's
  msgpack read back through `bridge` (`read_jax_checkpoint`,
  `state_dict_from_jax`), for all five ``--model`` kinds: the reference's
  own initial checkpoints in the repo (``evidence/round5/{wsb,br,gf}/
  ref_init_checkpoint.tar.gz``, gunzipped here) for ``votenet``,
  ``votenet_da`` and ``groupfree``; for ``votenet_da_jitter`` and
  ``groupfree_da``, whose reference checkpoints the repo lacks, a
  reference-layout state_dict made from a seed by the names and shapes the
  importer reads (`backtoreality_tpu/tools/torch_import.py:174-221,
  356-378`). Each import loads strictly into the port's graph.
* The CLI round trip: import WSB's init, then ``evaluate --query_mode
  exact --device cpu`` scores it.
* `load_weights` refuses a reference checkpoint passed as it is, both
  layouts, naming the import tool.
* `tools.parity_fixture` writes the ``parity`` and ``br`` fixtures byte
  for byte as the JAX tool does (2 train and 1 val scan).
* `tools.parity_report` reproduces ``evidence/round5/{wsb,br,cr,gf}/
  parity_report.txt`` from the JAX legs' files, and its report equals the
  JAX ``build_report``'s.
"""

import argparse
import gzip
import math
import pathlib
import shutil

import numpy as np
import pytest
import torch

from backtoreality_tpu.tools import parity_fixture as jfixture
from backtoreality_tpu.tools import parity_report as jreport
from backtoreality_tpu.tools import torch_import as jimport
from backtoreality_tpu_torch import bridge
from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.synthetic import write_synthetic_scans
from backtoreality_tpu_torch.tools import parity_fixture as tfixture
from backtoreality_tpu_torch.tools import parity_report as treport
from backtoreality_tpu_torch.tools import torch_import as timport
from backtoreality_tpu_torch.train import common as tcommon
from backtoreality_tpu_torch.train import evaluate, groupfree

EVIDENCE = pathlib.Path("evidence/round5")
GF_FLAGS = ["--num_decoder_layers", "2", "--dim_feedforward", "128",
            "--use_height"]


@pytest.fixture(scope="module")
def inits(tmp_path_factory):
    """The three evidence inits, gunzipped: {name: path}."""
    d = tmp_path_factory.mktemp("ref_inits")
    out = {}
    for name in ("wsb", "br", "gf"):
        out[name] = d / f"{name}.tar"
        with gzip.open(EVIDENCE / name / "ref_init_checkpoint.tar.gz") as f:
            out[name].write_bytes(f.read())
    return out


def _port_graph(model):
    """The port's graph of a ``--model`` kind, at the inits' widths."""
    cfg = get_config("scannet_md40")
    if model.startswith("groupfree"):
        flags = groupfree.add_flags(argparse.ArgumentParser()).parse_args(
            GF_FLAGS)
        return groupfree.build_model(flags, cfg, model[len("groupfree_"):]
                                     or "plain")
    flags = evaluate.add_common_flags(argparse.ArgumentParser()).parse_args(
        [])
    return evaluate.build_model(flags, cfg, model[len("votenet_"):]
                                or "plain")


# the heads the inits lack: (port prefix, reference prefix, hidden conv+BN
# layers, a final biased conv) for torch Conv1d/BN1d stacks numbered as
# nn.Sequential numbers them (conv, BN, ReLU, ...)
_STACKS = {
    "votenet_da_jitter": [("da_heads.global_netD1", "global_netD1", 2, False),
                          ("da_heads.local_netD", "local_netD", 2, True),
                          ("jitter_netD", "jitter_netD", 2, True),
                          ("jitter_net", "jitter_net", 1, True)],
    "groupfree_da": [("da_heads.global_netD1", "global_netD1", 2, False),
                     ("da_heads.decoder_netD", "decoder_netD", 2, True)],
}


def _reference_heads(model, rng):
    """Reference-layout tensors, drawn from `rng`, for the heads of the
    `model` kind that the evidence inits lack, shaped after the port's
    graph: the domain discriminators, and for the jitter graph its ctjt
    head (`pt_utils.SharedMLP`, one layer) and jitter nets."""
    shapes = {k: tuple(v.shape)
              for k, v in _port_graph(model).state_dict().items()}

    def draw(shape, positive=False):
        a = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(np.abs(a) + 0.5 if positive else a)

    def bn(ref, port, out):
        width = shapes[f"{port}.weight"]
        out[f"{ref}.weight"], out[f"{ref}.bias"] = draw(width), draw(width)
        out[f"{ref}.running_mean"] = draw(width)
        out[f"{ref}.running_var"] = draw(width, positive=True)

    sd = {}
    for port, ref, hidden, final in _STACKS[model]:
        for i in range(hidden):
            sd[f"{ref}.{3 * i}.weight"] = draw(
                shapes[f"{port}.dense{i}.weight"] + (1,))
            sd[f"{ref}.{3 * i}.bias"] = draw(
                shapes[f"{port}.dense{i}.weight"][:1])
            bn(f"{ref}.{3 * i + 1}", f"{port}.bn{i}", sd)
        if final:
            sd[f"{ref}.{3 * hidden}.weight"] = draw(
                shapes[f"{port}.out.weight"] + (1,))
            sd[f"{ref}.{3 * hidden}.bias"] = draw(shapes[f"{port}.out.bias"])
    sd["global_netD2.weight"] = draw(shapes["da_heads.global_netD2.weight"])
    sd["global_netD2.bias"] = draw(shapes["da_heads.global_netD2.bias"])
    if model == "votenet_da_jitter":
        ref = "backbone_net.ctjt_head.mlp_module.layer0"
        sd[f"{ref}.conv.weight"] = draw(
            shapes["backbone_net.ctjt.mlp.dense0.weight"] + (1, 1))
        bn(f"{ref}.bn.bn", "backbone_net.ctjt.mlp.bn0", sd)
    return sd


def _reference_file(model, inits, tmp_path):
    """A reference checkpoint of the `model` kind: an evidence init, or
    one made from a seed in the layout of its training script."""
    if model in ("votenet", "votenet_da", "groupfree"):
        return inits[{"votenet": "wsb", "votenet_da": "br",
                      "groupfree": "gf"}[model]]
    base = inits["wsb" if model == "votenet_da_jitter" else "gf"]
    payload = torch.load(base, map_location="cpu", weights_only=True)
    key = "model_state_dict" if "model_state_dict" in payload else "model"
    payload[key].update(_reference_heads(model, np.random.default_rng(9)))
    payload["epoch"] = 7
    path = tmp_path / f"{model}.tar"
    torch.save(payload, path)
    return path


@pytest.mark.parametrize("model", list(timport.CONVERTERS))
def test_import_equals_jax_importer(model, inits, tmp_path):
    src = _reference_file(model, inits, tmp_path)
    jax_out, port_out = tmp_path / "jax.msgpack", tmp_path / "port.pt"
    want_count = jimport.import_checkpoint(src, model, jax_out)
    assert timport.import_checkpoint(src, model, port_out) == want_count
    variables, epoch = bridge.read_jax_checkpoint(jax_out)
    assert epoch == want_count[1] == (7 if model in _STACKS else -1)
    want = bridge.state_dict_from_jax(variables)
    got = torch.load(port_out, map_location="cpu", weights_only=True)
    assert sorted(got) == sorted(want)  # msgpack writes its keys sorted
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    _port_graph(model).load_state_dict(got)  # strict: every entry


def test_cli_round_trip_scores_in_exact_mode(inits, tmp_path, capsys):
    out = tmp_path / "wsb.pt"
    timport.main([str(inits["wsb"]), "--model", "votenet", "--out",
                  str(out)])
    printed = capsys.readouterr().out
    assert "imported 73 parameter tensors (epoch -1)" in printed
    assert "--query_mode exact" in printed
    scans = tmp_path / "scans"
    write_synthetic_scans(scans, get_config("scannet_md40"), num_scans=2,
                          num_objects=4, points_per_object=400,
                          floor_points=800, seed=4)
    results = evaluate.main([
        "--checkpoint_path", str(out), "--query_mode", "exact", "--device",
        "cpu", "--data_root", str(scans), "--split", "all", "--num_point",
        "2048", "--batch_size", "2", "--num_target", "32"])
    assert set(results) == {("", 0.25), ("", 0.5)}
    assert all(math.isfinite(m["mAP"]) for m in results.values())
    assert "copied 73 leaves, kept 0 fresh" in capsys.readouterr().out


@pytest.mark.parametrize("name,graph", [("wsb", "votenet"),
                                        ("gf", "groupfree")])
def test_load_weights_refuses_a_reference_checkpoint(name, graph, inits):
    """VoteNet's ``{"model_state_dict", ...}`` and GF's ``{"epoch",
    "model", "optimizer", "scheduler"}``: neither is taken for a port
    checkpoint; the message names the import tool."""
    with pytest.raises(SystemExit,
                       match="backtoreality_tpu_torch.tools.torch_import"):
        tcommon.restore_weights(_port_graph(graph), inits[name], graph)


@pytest.mark.parametrize("kind", ["parity", "br"])
def test_parity_fixture_writes_the_jax_tools_files(kind, tmp_path):
    args = ["--kind", kind, "--train_scans", "2", "--val_scans", "1"]
    jfixture.main(args + ["--out", str(tmp_path / "jax")])
    tfixture.main(args + ["--out", str(tmp_path / "port")])
    want = sorted(p.relative_to(tmp_path / "jax")
                  for p in (tmp_path / "jax").rglob("*.npy"))
    got = sorted(p.relative_to(tmp_path / "port")
                 for p in (tmp_path / "port").rglob("*.npy"))
    assert got == want and len(want) == (12 if kind == "parity" else 20)
    if kind == "br":
        assert any(p.name.startswith("scene_aug0000_00_1") for p in want)
    for rel in want:
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "jax" / rel).read_bytes()), rel


@pytest.mark.parametrize("pair", ["wsb", "br", "cr", "gf"])
def test_parity_report_reproduces_the_evidence(pair, tmp_path, capsys):
    ref, ours = tmp_path / "ref", tmp_path / "ours"
    ref.mkdir()
    ours.mkdir()
    shutil.copy(EVIDENCE / pair / "ref_history.jsonl", ref / "history.jsonl")
    shutil.copy(EVIDENCE / pair / "ours_metrics.jsonl",
                ours / "metrics.jsonl")
    report = treport.main(["--ref_dir", str(ref), "--ours_dir", str(ours)])
    assert capsys.readouterr().out == (
        EVIDENCE / pair / "parity_report.txt").read_text()
    assert report == jreport.build_report(str(ref), str(ours))
