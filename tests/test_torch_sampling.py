"""``--cluster_sampling random`` in the port's VoteNet loops, on the CPU.

The JAX loops fold the step into ``PRNGKey(seed)`` for a train step,
split that key into source and target in the DA step, and evaluate every
batch under ``PRNGKey(0)`` (``backtoreality_tpu/train/votenet.py``). JAX's
draws cannot be replayed in torch (the module is held against the JAX one
with the draws injected, ``tests/test_torch_surface.py``), so these tests
pin the loops' contract instead:

* a train step draws from ``common.draw_generator(seed, step)``, the DA
  step from (seed, step, 0) for the source and (seed, step, 1) for the
  target, an evaluation batch from (0,): so draws differ between steps
  and between the domains and are equal for every evaluation batch
  (recorded at the proposal module of the model a ``main`` builds);
* nothing reads or advances the global RNG once the model is built;
* two ``votenet_fsb.main`` runs with one seed give bitwise-equal losses
  and evaluations, and ``--resume`` goes on with the step count the draws
  need (the epoch after it equals the uninterrupted run's, bitwise);
* the port's ``evaluate`` refuses ``random`` with its reason, as the
  JAX package's passes no rng; so does BN recalibration in the loops.

Every size is small: B=2, N=2048, 64 proposals.
"""

import json

import numpy as np
import pytest
import torch

from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.synthetic import write_synthetic_scans
from backtoreality_tpu_torch.train import common as tcommon
from backtoreality_tpu_torch.train import (evaluate, votenet, votenet_br,
                                           votenet_fsb)

B, N, NUM_PROPOSAL = 2, 2048, 64


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once on a few cores, and more threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """Two real scans (one batch an epoch, one evaluation batch) and two
    virtual ones."""
    cfg = get_config("scannet_md40")
    real = tmp_path_factory.mktemp("torch_sampling_real")
    virtual = tmp_path_factory.mktemp("torch_sampling") / "obj_aug"
    write_synthetic_scans(real, cfg, num_scans=B, num_objects=3,
                          points_per_object=300, floor_points=800, seed=0)
    write_synthetic_scans(virtual, cfg, num_scans=2, num_objects=3,
                          points_per_object=300, floor_points=800, seed=1,
                          prefix="scene_aug")
    return dict(real=real, virtual=virtual)


class Draws:
    """Patches ``votenet.build_model`` so that every model a loop builds
    records its proposal module's seed indices of each forward (with the
    mode), and the global RNG's state once the model is built (the loop
    seeds it for the weights; nothing after that may read it)."""

    def __init__(self, monkeypatch):
        self.seen, self.rng = [], []
        build = votenet.build_model

        def recorded(*args, **kwargs):
            model = build(*args, **kwargs)
            model.pnet.register_forward_hook(
                lambda mod, a, out: self.seen.append(
                    (mod.training, out["aggregated_vote_inds"].clone())))
            self.rng.append(torch.get_rng_state())
            return model

        monkeypatch.setattr(votenet, "build_model", recorded)

    def train(self):
        return [inds for training, inds in self.seen if training]

    def eval(self):
        return [inds for training, inds in self.seen if not training]


def _expected(*key):
    """What a forward draws from the generator of `key`: (B, P) of the
    1024 seeds."""
    return torch.randint(0, 1024, (B, NUM_PROPOSAL),
                         generator=tcommon.draw_generator("cpu", *key),
                         dtype=torch.int32)


def _equal(got, want):
    return len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))


def _fsb_args(fixtures, log_dir, max_epoch, *extra):
    return ["--data_root", str(fixtures["real"]), "--train_split", "all",
            "--val_split", "all", "--log_dir", str(log_dir), "--max_epoch",
            str(max_epoch), "--eval_freq", "1", "--num_point", str(N),
            "--batch_size", str(B), "--num_target", str(NUM_PROPOSAL),
            "--cluster_sampling", "random", "--device", "cpu", *extra]


def _rows(log_dir):
    """metrics.jsonl without its wall-clock fields."""
    rows = [json.loads(line) for line in
            (log_dir / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in ("scenes_per_sec",
                                                     "time")}
            for r in rows]


def test_fsb_main_draws_repeatably_and_resumes_the_draws(
        fixtures, tmp_path, monkeypatch):
    """Two epochs of one step and an evaluation each, against one epoch
    and a resumed second: the first epochs are two runs of one seed, the
    second epoch's draws need the step count the checkpoint carries. A
    step draws from (--seed, step), every evaluation batch from (0,), and
    nothing reads the global RNG once the model is built."""
    draws = Draws(monkeypatch)
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    votenet_fsb.main(_fsb_args(fixtures, whole, 2, "--seed", "5"))
    assert torch.equal(torch.get_rng_state(), draws.rng[0])
    assert _equal(draws.train(), [_expected(5, 0), _expected(5, 1)])
    assert _equal(draws.eval(), [_expected(0)] * 2)
    assert not torch.equal(*draws.train())
    votenet_fsb.main(_fsb_args(fixtures, cut, 1, "--seed", "5"))
    assert _rows(cut) == _rows(whole)[:len(_rows(cut))]
    votenet_fsb.main(_fsb_args(
        fixtures, cut, 2, "--seed", "5", "--resume", "--checkpoint_path",
        str(cut / "checkpoint.tar")))
    rows = _rows(whole)
    assert [r.get("kind", "train") for r in rows] == ["train", "eval"] * 2
    assert _rows(cut) == rows
    assert _equal(draws.train()[2:], [_expected(5, 0), _expected(5, 1)])


def test_br_main_draws_apart_for_source_and_target(fixtures, tmp_path,
                                                   monkeypatch):
    draws = Draws(monkeypatch)
    _, opt = votenet_br.main([
        "--data_root", str(fixtures["real"]), "--source_data_root",
        str(fixtures["virtual"]), "--train_split", "all", "--val_split",
        "all", "--log_dir", str(tmp_path / "br"), "--max_epoch", "1",
        "--eval_freq", "1", "--num_point", str(N), "--batch_size", str(B),
        "--num_target", str(NUM_PROPOSAL), "--cluster_sampling", "random",
        "--seed", "3", "--device", "cpu"])
    assert torch.equal(torch.get_rng_state(), draws.rng[0])
    assert tcommon.optimizer_steps(opt) == 1
    # the source's forward, then the target's, then the evaluation's
    assert _equal(draws.train(), [_expected(3, 0, 0), _expected(3, 0, 1)])
    assert _equal(draws.eval(), [_expected(0)])
    rows = _rows(tmp_path / "br")
    assert np.isfinite(rows[0]["loss"]) and np.isfinite(rows[-1]["mAP"])


def test_random_refused_where_no_generator_is_passed(fixtures, tmp_path,
                                                     capsys):
    with pytest.raises(SystemExit):
        votenet_fsb.main(_fsb_args(fixtures, tmp_path / "recal", 1,
                                   "--bn_recal_batches", "2"))
    assert "--bn_recal_batches 0" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        evaluate.main(["--checkpoint_path", str(tmp_path / "none.pt"),
                       "--data_root", str(fixtures["real"]),
                       "--cluster_sampling", "random", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "not scored by evaluate" in err and "passes no rng" in err
