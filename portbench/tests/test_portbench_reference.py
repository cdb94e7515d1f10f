"""The plain reference of ``portbench/reference/`` against the system's
CPU path, at every published width and at small sizes (2 scans of 2048
points): the same state dict names and shapes, FPS and the ball query,
the forwards, the criteria, the gradients and the optimizers' updates.
The system's CPU path takes each kernel's plain version; its ball query
is given the kernel's radius test where a whole forward or step is
compared (the ``kernel_query`` fixture, see ``portbench/conftest.py``)."""

import importlib

import numpy as np
import pytest
import torch

from portbench import traffic, weights
from portbench.conftest import small
from portbench.modes import train
from portbench.reference import ops as ref_ops
from portbench.reference import optim as ref_optim

FAMILIES = {"votenet": "votenet-serve-b8", "groupfree": "gf-serve-b32"}


def _family(name):
    return importlib.import_module(f"portbench.families.{name}")


def _cloud(seed, n=2048):
    loaded = small("votenet-serve-b8")
    batch = traffic.pool(seed, loaded["traffic"], loaded["config"])[0]
    return torch.from_numpy(batch["point_clouds"][..., :3])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_state_dict_names_and_shapes(family):
    fam = _family(family)
    config = small(FAMILIES[family])["config"]
    with torch.device("meta"):
        ref = importlib.import_module(
            f"portbench.reference.{family}").build(config)
    assert {k: v.shape for k, v in ref.state_dict().items()} == \
        fam.shapes(config)


@pytest.mark.parametrize("npoint", [256, 2048])
def test_fps_equals_the_system(npoint):
    fps = importlib.import_module("backtoreality_tpu_torch.ops.fps")
    xyz = _cloud(1)
    assert torch.equal(ref_ops.furthest_point_sample(xyz, npoint),
                       fps._fps_torch(xyz, npoint))


@pytest.mark.parametrize("radius,nsample", [(0.2, 64), (0.4, 32),
                                            (1.2, 16)])
def test_ball_query_differs_only_at_the_radius(radius, nsample):
    """Slots differ from the system's CPU stand-in only where a point lies
    within a few float32 ulps of (|c| + |p|)^2 of the radius."""
    bq = importlib.import_module("backtoreality_tpu_torch.ops.ball_query")
    xyz = _cloud(2)
    centres = ref_ops.gather_points(
        xyz, ref_ops.furthest_point_sample(xyz, 512))
    mine, mine_hit = ref_ops.ball_query_stratified(xyz, centres, radius,
                                                   nsample)
    theirs, theirs_hit = bq._ball_query_stratified_torch(xyz, centres,
                                                         radius, nsample)
    # slots whose own bucket has a hit on either side (fill slots follow)
    differ = (((mine != theirs) & (mine_hit | theirs_hit))
              | (mine_hit != theirs_hit))
    b, m, _ = differ.nonzero(as_tuple=True)
    c = centres[b, m].double()
    gaps = []
    for idx in (mine, theirs):
        p = xyz[b, idx[differ].long()].double()
        gaps.append((((p - c) ** 2).sum(-1) - radius * radius).abs()
                    / (p.norm(dim=-1) + c.norm(dim=-1)) ** 2)
    assert bool((torch.minimum(*gaps) <= 4 * 2.0 ** -24).all())
    assert int(mine_hit.sum()) > 1000  # the test sees hits


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_equals_the_system(family, kernel_query):
    """Eval-mode forwards from the same weights: every end point both
    produce, equal."""
    fam = _family(family)
    loaded = small(FAMILIES[family])
    config = loaded["config"]
    shapes = fam.shapes(config)
    w = weights.make(shapes, 11, torch.device("cpu"))
    model, _ = fam.program_server(config, torch.device("cpu"), w)
    ref = fam.reference_model(config, torch.device("cpu"), w).eval()
    points = torch.from_numpy(traffic.pool(
        11, loaded["traffic"], config)[0]["point_clouds"])
    with torch.no_grad():
        ours, theirs = model(points), ref(points)
    shared = set(ours) & set(theirs)
    assert len(shared) > 20
    for k in shared:
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("cell", ["votenet-train-b8", "gf-train-b32"])
def test_train_steps_equal_the_system(cell, cpu_context, kernel_query):
    """Three steps: the losses equal, the gradients and the change over
    the steps within rounding (the clip's norm and Adam's arithmetic are
    summed in another order)."""
    ctx = cpu_context(cell)
    session = train.Session(ctx)
    prog = session.first_steps()
    got = train.numbers(prog, train.reference_steps(ctx, session.host_pool,
                                                    prog))
    assert got["loss_gap"] == 0.0
    assert got["grad_gap"] < 1e-5
    assert got["change_gap"] < 1e-4


@pytest.mark.parametrize("kind", ["adam", "adamw_clip"])
def test_optimizer_equals_torch(kind):
    """The reference's Adam and AdamW (with the clip to a global norm)
    against torch.optim's, three steps."""
    from backtoreality_tpu_torch.train import common

    gen = torch.Generator().manual_seed(5)
    params = {f"p{i}": torch.randn(50, generator=gen, requires_grad=True)
              for i in range(3)}
    mine = {n: p.detach().clone().requires_grad_() for n, p in
            params.items()}
    if kind == "adam":
        opt = common.make_optimizer(params.values(), "adam", lr0=1e-3)
        ref = ref_optim.Adam(mine.items(), lambda n: 1e-3)
    else:
        opt = common.make_optimizer(params.values(), "adamw",
                                    weight_decay=5e-4, grad_clip=0.1,
                                    lr0=4e-3)
        ref = ref_optim.Adam(mine.items(), lambda n: 4e-3,
                             weight_decay=5e-4, clip=0.1)
    for _ in range(3):
        grads = {n: torch.randn(50, generator=gen) for n in params}
        for n in params:
            params[n].grad = grads[n].clone()
            mine[n].grad = grads[n].clone()
        opt.step()
        ref.step()
    for n in params:
        np.testing.assert_allclose(mine[n].detach().numpy(),
                                   params[n].detach().numpy(), rtol=1e-5,
                                   atol=1e-7)
