"""The port's BN recalibration (``--bn_recal_batches``, ``evaluate``'s
``--train_data_root`` / ``--recal_split``) and determinism switch against
the JAX package's, on the CPU, at small widths (B=2, N=2048, 64
proposals; GroupFree3D with 32 queries, 2 decoder layers, feed-forward
width 96).

* Recalibration: 3 train-mode batches (the loader restarted after its 2)
  at momentum 0.2 through the JAX package's ``make_recal_step`` /
  ``recalibrate_bn`` and the port's, from one bridged state; the
  parameters untouched. Float32: the set-abstraction stages' running
  means and variances within 1e-5 of each vector's largest magnitude
  (means over 65536 rows in another order, and the variance as
  E[x^2] - E[x]^2, which cancels: 2e-6 measured; the FP layers' weights
  and the vote FPS over their outputs make the later statistics differ
  by the forward's own error, up to 3e-2 at vote clustering). bfloat16
  (f32_tail 2): the backbone's statistics within 2e-2 (1e-2 measured:
  bfloat16 products accumulate in another order). GroupFree3D with
  dropout 0 (JAX dropout draws cannot be replayed).
* The recal loader (augment, shuffle, drop_last, as ``evaluate`` builds
  it) yields the JAX loader's batches, array for array.
* The training loops around an in-loop recalibration (``votenet_fsb``,
  ``gf_fsb``, ``--bf16``, an evaluation after each of 2 epochs of one
  step, one recalibration batch): the recalibration moves the BN
  statistics, and the next step starts from the statistics and the global
  RNG state the last one left.
* ``evaluate``: an implied recalibration without ``--train_data_root``
  warns and scores, an explicit one exits, an empty recal loader exits.
* ``lad_t2`` (bfloat16, f32_tail 2) scored on 4 scans of its own domain
  (the shapefix val, N=8192) through both packages' ``evaluate --bf16
  --f32_tail 2 --bn_recal_batches 2`` over 2 seeds: each IoU's mean mAP
  within 0.1 of the JAX package's (0.024 and 0.050 measured: on 4 scans
  one box crossing an IoU threshold moves its class's AP by a whole
  instance's share, and bfloat16 products accumulate in another order;
  the gate on the card scores 100 scans).
* After every entry point's ``main`` the determinism switch is on
  (``torch.are_deterministic_algorithms_enabled()``,
  ``CUBLAS_WORKSPACE_CONFIG``); a fixture puts both back afterwards.
"""

import gzip
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from backtoreality_tpu.data import scannet_md40_config as jax_config
from backtoreality_tpu.data.dataset import DetectionDataset as JaxDataset
from backtoreality_tpu.data.loader import DetectionDataLoader as JaxLoader
from backtoreality_tpu.data.synthetic import write_synthetic_scans
from backtoreality_tpu.models import groupfree as jgf
from backtoreality_tpu.models import votenet as jvn
from backtoreality_tpu.parallel import make_mesh
from backtoreality_tpu.train import common as jcommon
from backtoreality_tpu.train import evaluate as jax_evaluate
from backtoreality_tpu.train import groupfree as jax_gf_train
from backtoreality_tpu.train import votenet as jax_vn_train
from backtoreality_tpu_torch.bridge import state_dict_from_jax
from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.dataset import DetectionDataset
from backtoreality_tpu_torch.data.loader import DetectionDataLoader
from backtoreality_tpu_torch.datagen.shapefix import write_shapefix_val
from backtoreality_tpu_torch.models import groupfree as tgf
from backtoreality_tpu_torch.models import votenet as tvn
from backtoreality_tpu_torch.train import common as tcommon
from backtoreality_tpu_torch.train import (evaluate, gf_fsb, groupfree,
                                           votenet, votenet_fsb)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAD_T2 = ROOT / "evidence/round4/ckpt/lad_t2.tar.gz"
B, N = 2, 2048
GF_SMALL = dict(num_proposal=32, num_decoder_layers=2, dim_feedforward=96,
                dropout_rate=0.0)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once on a few cores, and more threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def determinism_restored(monkeypatch):
    """The entry points turn the determinism switch on for the process;
    put it back as it was for the worker's other tests."""
    mode = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    yield
    torch.use_deterministic_algorithms(mode)
    torch.utils.deterministic.fill_uninitialized_memory = fill


def _assert_switch_on():
    assert torch.are_deterministic_algorithms_enabled()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_recal_scans")
    write_synthetic_scans(d, jax_config(), num_scans=4, num_objects=4,
                          points_per_object=400, floor_points=800, seed=6)
    return d


@pytest.fixture(scope="module")
def two_scans(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_recal_two_scans")
    write_synthetic_scans(d, jax_config(), num_scans=B, num_objects=4,
                          points_per_object=400, floor_points=800, seed=7)
    return d


# ---------------------------------------------------------------------------
# recalibration against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,arm", [("votenet", "f32"),
                                       ("votenet", "bf16"),
                                       ("groupfree", "bf16")])
def test_recalibration_matches_jax(scans, model, arm):
    cfg = jax_config()
    ds = JaxDataset(cfg, scans, split="all", num_points=N, use_height=True,
                    augment=True, gf_labels=model == "groupfree")
    batches = list(JaxLoader(ds, B, shuffle=True, drop_last=True))
    assert len(batches) == 2
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    kw = dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
              num_size_cluster=cfg.num_size_cluster, input_feature_dim=1,
              **(dict(num_proposal=64) if model == "votenet" else GF_SMALL))
    if arm == "bf16":
        kw["f32_tail"] = 2
    jax_cls, trainer, port_cls = (
        (jvn.VoteNet, jax_vn_train, tvn.VoteNet) if model == "votenet"
        else (jgf.GroupFreeDetector, jax_gf_train, tgf.GroupFreeDetector))
    jmodel = jax_cls(mean_size_arr=msa, dtype=jnp.bfloat16 if arm == "bf16"
                     else jnp.float32, **kw)
    variables = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(batches[0]["point_clouds"][:1]),
        train=False))
    state = jcommon.TrainState(step=0, params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=None)
    state = trainer.recalibrate_bn(state, batches,
                                   trainer.make_recal_step(jmodel),
                                   make_mesh(1), 3)
    want = state_dict_from_jax({"params": variables["params"],
                                "batch_stats": jax.device_get(
                                    state.batch_stats)})

    port = port_cls(mean_size_arr=cfg.mean_size_arr,
                    dtype=torch.bfloat16 if arm == "bf16" else None, **kw)
    port.load_state_dict(state_dict_from_jax(variables))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    done = tcommon.recalibrate_bn(batches, tcommon.make_recal_step(port),
                                  "cpu", 3)
    assert done == 3
    checked = 0
    for name, got in port.state_dict().items():
        if not name.endswith(("running_mean", "running_var")):
            assert torch.equal(got, before[name]), name  # params untouched
            continue
        assert got.dtype == torch.float32, name
        assert not torch.equal(got, before[name]), name
        if not name.startswith("backbone_net.sa" if arm == "f32"
                               else "backbone_net."):
            continue
        w = want[name].numpy()
        err = np.abs(got.numpy() - w).max() / np.abs(w).max()
        assert err <= (1e-5 if arm == "f32" else 2e-2), (name, err)
        checked += 1
    assert checked >= 24


def test_recal_loader_matches_jax(scans):
    """The loader `evaluate` builds for recalibration against the JAX
    package's: the same batches, array for array."""
    kw = dict(split="all", num_points=N, use_height=True, augment=True)
    want = list(JaxLoader(JaxDataset(jax_config(), scans, **kw), B,
                          shuffle=True, drop_last=True))
    got = list(DetectionDataLoader(
        DetectionDataset(get_config("scannet_md40"), scans, **kw), B,
        shuffle=True, drop_last=True))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# the training loops
# ---------------------------------------------------------------------------


def _buffers(model):
    return [b.clone() for b in model.buffers()]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("recipe", ["votenet_fsb", "gf_fsb"])
def test_recalibration_leaves_the_training_state(two_scans, tmp_path,
                                                 monkeypatch, recipe,
                                                 determinism_restored):
    """Each train step, and each recalibration, recorded by wrapping the
    loop's step builder and `common.recalibrate_bn`."""
    module = votenet if recipe == "votenet_fsb" else groupfree
    events = []
    models = []
    make_train_step = module.make_train_step
    recalibrate_bn = tcommon.recalibrate_bn

    def spy_make_train_step(model, *args, **kwargs):
        step = make_train_step(model, *args, **kwargs)
        models.append(model)

        def spied(*a):
            events.append(("before", _buffers(model), torch.get_rng_state()))
            out = step(*a)
            events.append(("after", _buffers(model), torch.get_rng_state()))
            return out

        return spied

    def spy_recalibrate_bn(*args):
        done = recalibrate_bn(*args)
        events.append(("recal", _buffers(models[0]), None))
        return done

    monkeypatch.setattr(module, "make_train_step", spy_make_train_step)
    monkeypatch.setattr(tcommon, "recalibrate_bn", spy_recalibrate_bn)
    if recipe == "votenet_fsb":
        main, args = votenet_fsb.main, ["--num_target", "64",
                                        "--eval_freq", "1"]
    else:
        main, args = gf_fsb.main, [
            "--use_height", "--num_target", "32", "--num_decoder_layers",
            "2", "--dim_feedforward", "96", "--val_freq", "1"]
    main(args + ["--data_root", str(two_scans), "--train_split", "all",
                 "--val_split", "all", "--max_epoch", "2", "--num_point",
                 str(N), "--batch_size", str(B), "--device", "cpu",
                 "--bf16", "--bn_recal_batches", "1", "--log_dir",
                 str(tmp_path)])
    _assert_switch_on()
    assert [e[0] for e in events] == ["before", "after", "recal"] * 2
    _, after, rng_after = events[1]
    _, recal, _ = events[2]
    _, before, rng_before = events[3]
    assert not _same(recal, after)  # the recalibration moved them
    assert _same(before, after)  # and the next step did not see it
    assert torch.equal(rng_before, rng_after)


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------


def _eval_args(scans, *extra):
    return ["--checkpoint_path", str(LAD_T2), "--data_root", str(scans),
            "--split", "all", "--num_point", str(N), "--num_target", "64",
            "--batch_size", str(B), "--device", "cpu", *extra]


def test_evaluate_recal_flags(scans, capsys, determinism_restored):
    results = evaluate.main(_eval_args(scans, "--bf16"))
    out = capsys.readouterr().out
    assert "warning: BN recalibration implied by --bf16" in out
    assert "recalibrated" not in out
    assert all(np.isfinite(m["mAP"]) for m in results.values())
    _assert_switch_on()
    with pytest.raises(SystemExit, match="requires --train_data_root"):
        evaluate.main(_eval_args(scans, "--bn_recal_batches", "1"))
    with pytest.raises(SystemExit, match="loader is empty"):
        evaluate.main(_eval_args(scans, "--bf16", "--train_data_root",
                                 str(scans), "--batch_size", "8"))


def test_lad_t2_scores_match_jax(tmp_path, capsys, determinism_restored):
    """lad_t2 on 4 scans of its own domain (the shapefix val, seed 33) at
    N=8192 through both packages' evaluate, 2 seeds: the means within
    0.1."""
    val = tmp_path / "val"
    write_shapefix_val(val, num_scans=4, seed=33)
    # the JAX package's evaluate reads the msgpack uncompressed
    raw = tmp_path / "lad_t2.msgpack"
    raw.write_bytes(gzip.decompress(LAD_T2.read_bytes()))
    args = ["--data_root", str(val), "--split", "all", "--num_point",
            "8192", "--num_target", "256", "--batch_size", str(B),
            "--eval_seeds", "2", "--bf16", "--f32_tail", "2",
            "--bn_recal_batches", "2", "--train_data_root", str(val)]
    jax_evaluate.main(args + ["--checkpoint_path", str(raw),
                              "--num_devices", "1"])
    want = capsys.readouterr().out
    got = evaluate.main(args + ["--checkpoint_path", str(LAD_T2),
                                "--device", "cpu"])
    out = capsys.readouterr().out
    _assert_switch_on()
    for text in (want, out):
        assert "recalibrated BN stats over 2 train batches" in text
    for t in (0.25, 0.5):
        # the JAX package prints "mAP: mean +/- sigma  (seeds: a b)"
        block = want.split(f"===== votenet @ IoU {t} =====")[1]
        line = next(x for x in block.splitlines() if "mAP:" in x)
        jax_mean = float(line.split("mAP:")[1].split()[0])
        assert len(got[("", t)]["seeds"]) == 2
        assert abs(got[("", t)]["mAP"] - jax_mean) <= 0.1, (t, jax_mean)
