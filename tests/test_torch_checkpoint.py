"""The port's reader of the JAX package's checkpoints, and the JAX-trained
checkpoint through the port, on the CPU.

* `bridge.load_msgpack` against `flax.serialization.msgpack_restore`:
  bit-exact on `evidence/round4/ckpt/lad_f32.tar.gz` (a gzipped msgpack
  that `backtoreality_tpu/train/common.py::save_checkpoint` wrote, epoch
  599), every array of the state included (`opt_state` too), and on a
  crafted tree that holds every msgpack type the decoder reads (each
  width of int, float, str, bin, array and map; nil and booleans; flax's
  ndarray and numpy-scalar extensions; a chunked array), gzipped and not.
* `train/common.load_weights` tells the three kinds of checkpoint apart
  by their leading bytes, and the port's `partial_restore` logs the
  counts of the JAX package's for the trained weights into VoteNet (all
  copied) and into the BR model (its domain heads kept fresh).
* The trained weights' end_points, port against JAX, on a small plain
  synthetic fixture (B=2, N=2048, 64 proposals), float64 in eval mode:
  indices exactly, floats to atol 1e-9; and `evaluate.main` scores the
  checkpoint file itself with ``--device cpu``.
"""

import gzip
import math
import pathlib
import re

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from backtoreality_tpu.data import scannet_md40_config as jax_config
from backtoreality_tpu.data.dataset import DetectionDataset
from backtoreality_tpu.data.synthetic import write_synthetic_scans
from backtoreality_tpu.models.votenet import VoteNet as JaxVoteNet
from backtoreality_tpu.models.votenet.da import VoteNetDA as JaxVoteNetDA
from backtoreality_tpu.train import common as jcommon
from backtoreality_tpu_torch import bridge
from backtoreality_tpu_torch.models.votenet import VoteNet, VoteNetDA
from backtoreality_tpu_torch.train import common as tcommon
from backtoreality_tpu_torch.train import evaluate

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "evidence/round4/ckpt/lad_f32.tar.gz"
B, N, NUM_PROPOSAL = 2, 2048, 64


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once on a few cores, and more threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _assert_same_tree(got, want, path="/"):
    """Equal structure, keys, types and values; arrays bit for bit with
    their dtype and shape."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}{k}/")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}{i}/")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture(scope="module")
def flax_payload():
    return serialization.msgpack_restore(gzip.decompress(CKPT.read_bytes()))


def test_reader_matches_flax_on_the_trained_checkpoint(flax_payload):
    got = bridge.load_msgpack(CKPT)
    _assert_same_tree(got, flax_payload)
    assert set(got["state"]) >= {"params", "batch_stats", "opt_state"}
    variables, epoch = bridge.read_jax_checkpoint(CKPT)
    assert epoch == flax_payload["epoch"] == 599
    leaves = [jax.tree_util.tree_leaves(variables[c])
              for c in ("params", "batch_stats")]
    assert [len(x) for x in leaves] == [73, 46]


def test_reader_matches_flax_on_every_type(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    tree = {
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                 -2**31, -2**31 - 1, -2**63],
        "floats": [0.5, -1e300, float("inf")],
        "strs": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256,
                 "v" * 70000, "ünïcödé"],
        "bins": [b"", b"\x00" * 300, b"\x01" * 70000],
        "flags": [None, True, False],
        "long_list": list(range(20)),
        "big_map": {str(i): i for i in range(20)},
        "arrays": {
            "f32": rng.normal(size=(3, 4)).astype(np.float32),
            "f64": rng.normal(size=(5,)),
            "f16": rng.normal(size=(2, 2)).astype(np.float16),
            "i32": rng.integers(-9, 9, (2, 3, 4)).astype(np.int32),
            "u8": rng.integers(0, 255, 7).astype(np.uint8),
            "bool": rng.random(6) > 0.5,
            "zero_d": np.asarray(2.5, np.float32),
            "empty": np.zeros((0, 3), np.float32),
            "large": rng.normal(size=(300, 300)).astype(np.float32),
        },
        "scalars": {"f32": np.float32(1.5), "i64": np.int64(-7),
                    "u16": np.uint16(9)},
    }
    blob = serialization.msgpack_serialize(tree)
    # a msgpack float32 (flax writes float64)
    blob32 = msgpack.packb({"f": 0.25}, use_single_float=True)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    chunked = serialization.msgpack_serialize(
        {"a": rng.normal(size=(10, 30)).astype(np.float32)})
    assert b"__msgpack_chunked_array__" in chunked
    for name, data in (("tree", blob), ("f32", blob32),
                       ("chunked", chunked)):
        want = serialization.msgpack_restore(data)
        for suffix, payload in (("", data), (".gz", gzip.compress(data))):
            path = tmp_path / f"{name}{suffix}"
            path.write_bytes(payload)
            _assert_same_tree(bridge.load_msgpack(path), want)

    (tmp_path / "trailing").write_bytes(blob32 + b"\x00")
    with pytest.raises(ValueError, match="after the msgpack object"):
        bridge.load_msgpack(tmp_path / "trailing")
    (tmp_path / "truncated").write_bytes(blob[:-10])
    with pytest.raises(ValueError, match="truncated"):
        bridge.load_msgpack(tmp_path / "truncated")


def test_load_weights_tells_the_kinds_apart(tmp_path, flax_payload):
    """A JAX checkpoint (gzipped or not), a torch.save of a state_dict and
    a training checkpoint give the same weights."""
    plain = tmp_path / "ckpt.msgpack"
    plain.write_bytes(gzip.decompress(CKPT.read_bytes()))
    sd, epoch = tcommon.load_weights(CKPT)
    assert epoch == 599
    sd2, epoch2 = tcommon.load_weights(plain)
    assert epoch2 == 599 and set(sd2) == set(sd)
    cfg = jax_config()
    model = VoteNet(num_class=cfg.num_class,
                    num_heading_bin=cfg.num_heading_bin,
                    num_size_cluster=cfg.num_size_cluster,
                    mean_size_arr=cfg.mean_size_arr, input_feature_dim=1)
    model.load_state_dict(sd)  # strict: every leaf is there
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    sd3, epoch3 = tcommon.load_weights(tmp_path / "weights.pt")
    assert epoch3 is None
    opt = torch.optim.Adam(model.parameters())
    tcommon.save_checkpoint(tmp_path / "train.tar", model, opt, 3)
    sd4, epoch4 = tcommon.load_weights(tmp_path / "train.tar")
    assert epoch4 == 3
    for other in (sd2, sd3, sd4):
        for k, v in sd.items():
            assert torch.equal(other[k], v), k
    want = flax_payload["state"]["params"]["pnet"]["out"]["kernel"]
    np.testing.assert_array_equal(sd["pnet.out.weight"].numpy(), want.T)


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ckpt_scans")
    write_synthetic_scans(d, jax_config(), num_scans=B, num_objects=4,
                          points_per_object=400, floor_points=800, seed=4)
    return d


def _kw(cfg):
    return dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
                num_size_cluster=cfg.num_size_cluster, input_feature_dim=1,
                num_proposal=NUM_PROPOSAL)


@pytest.mark.parametrize("jax_cls,port_cls", [(JaxVoteNet, VoteNet),
                                              (JaxVoteNetDA, VoteNetDA)])
def test_partial_restore_counts_match_jax(flax_payload, jax_cls, port_cls):
    cfg = jax_config()
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    pc = jnp.zeros((1, 256, 4), jnp.float32)
    fresh = jax.device_get(jax.jit(
        lambda k, x: jax_cls(mean_size_arr=msa, **_kw(cfg)).init(
            k, x, train=False))(jax.random.PRNGKey(0), pc))
    said = []
    for coll in ("params", "batch_stats"):
        jcommon.partial_restore(fresh[coll], flax_payload["state"][coll],
                                log=said.append)
    model = port_cls(mean_size_arr=cfg.mean_size_arr, **_kw(cfg))
    got = []
    sd, _ = tcommon.load_weights(CKPT)
    tcommon.partial_restore(model, sd, log=got.append)
    assert got == said
    if port_cls is VoteNet:
        assert got == ["partial restore: copied 73 leaves, kept 0 fresh",
                       "partial restore: copied 46 leaves, kept 0 fresh"]
    else:
        assert all(int(re.search(r"kept (\d+)", s).group(1)) > 0
                   for s in got)


def test_trained_weights_end_points_match_jax_f64(scans):
    cfg = jax_config()
    ds = DetectionDataset(cfg, scans, split="all", num_points=N,
                          use_height=True)
    pc = np.stack([ds.get(i)["point_clouds"] for i in range(B)])
    variables, _ = bridge.read_jax_checkpoint(CKPT)
    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                 variables)
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    jax.config.update("jax_enable_x64", True)
    try:
        model = JaxVoteNet(mean_size_arr=msa, dtype=jnp.float64,
                           head_dtype=jnp.float64, **_kw(cfg))
        want = jax.device_get(jax.jit(
            lambda v, x: model.apply(v, x, train=False))(
                v64, jnp.asarray(pc, jnp.float64)))
    finally:
        jax.config.update("jax_enable_x64", False)
    port = VoteNet(mean_size_arr=cfg.mean_size_arr, **_kw(cfg))
    port.load_state_dict(bridge.state_dict_from_jax(v64))  # strict
    port.double().eval()
    with torch.no_grad():
        got = port(torch.from_numpy(pc).double())
    assert set(got) == set(want)
    for key in sorted(want):
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape, key
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9, err_msg=key)


def test_evaluate_scores_the_jax_checkpoint(scans, capsys):
    results = evaluate.main([
        "--checkpoint_path", str(CKPT), "--data_root", str(scans),
        "--split", "all", "--num_point", str(N), "--num_target", "64",
        "--batch_size", str(B), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "copied 73 leaves, kept 0 fresh" in out
    assert "from epoch 599" in out
    assert all(math.isfinite(m["mAP"]) for m in results.values())


def test_shapefix_val_equals_the_jax_fixture(tmp_path):
    """The port's shapefix writer against ``parity_fixture --kind
    shapefix``: the same files, bit for bit (2 val scans)."""
    from backtoreality_tpu.tools import parity_fixture
    from backtoreality_tpu_torch.datagen.shapefix import write_shapefix_val

    parity_fixture.main(["--kind", "shapefix", "--train_scans", "1",
                         "--val_scans", "2", "--val_seed", "33", "--out",
                         str(tmp_path / "jax")])
    names = write_shapefix_val(tmp_path / "port", num_scans=2, seed=33)
    want = sorted((tmp_path / "jax/val").glob("*.npy"))
    assert len(names) == 2 and len(want) == 8
    for f in want:
        got = np.load(tmp_path / "port" / f.name)
        ref = np.load(f)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), f.name


@pytest.mark.parametrize("flags,recalibrated", [
    (["--bn_recal_batches=1"], 1), ([], 0),
    (["--bf16", "--f32_tail=2", "--bn_recal_batches=1"], 1)])
def test_evaluate_takes_the_recal_and_precision_flags(scans, capsys, flags,
                                                      recalibrated):
    """`--train_data_root` with `--bn_recal_batches`, alone (no
    recalibration without `--bf16`), and with `--bf16 --f32_tail`."""
    results = evaluate.main([
        "--checkpoint_path", str(CKPT), "--data_root", str(scans),
        "--split", "all", "--num_point", str(N), "--num_target", "64",
        "--batch_size", str(B), "--device", "cpu", "--train_data_root",
        str(scans), *flags])
    out = capsys.readouterr().out
    assert ("recalibrated BN stats over 1 train batches" in out) == bool(
        recalibrated)
    assert all(math.isfinite(m["mAP"]) for m in results.values())
