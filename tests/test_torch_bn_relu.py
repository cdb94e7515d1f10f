"""Eval-mode BatchNorm with its ReLU (`BatchNorm.forward(x, relu=True)`,
``ops/bn_relu.py``): training mode and the CPU give bit for bit the torch
sequence (BatchNorm, then ``torch.relu``); on the card every eval call
takes the kernel, float32 or bfloat16, and what it cannot take raises;
every BatchNorm -> ReLU pair of the models goes through the one entry,
as many a forward as ``chip_smoke.py`` expects, shown with a recording
stand-in for the kernel's library on the CPU; the launch and byte
counters. CPU only; imports nothing of JAX."""

from __future__ import annotations

import argparse
import collections
import ctypes
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.models.votenet import (BoxNet,
                                                    Pointnet2BackboneCam,
                                                    VoteNetDAJitter2)
from backtoreality_tpu_torch.nn import BatchNorm
from backtoreality_tpu_torch.ops import _build
from backtoreality_tpu_torch.ops import bn_relu
from backtoreality_tpu_torch.train import evaluate, groupfree, votenet

B, N, K = 2, 2048, 64


def _values(address: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    """The n float32 or bfloat16 values at `address` (host memory) as a
    tensor that shares them."""
    kind = ctypes.c_int16 if dtype == torch.bfloat16 else ctypes.c_float
    t = torch.from_numpy(np.ctypeslib.as_array(
        (kind * n).from_address(address)))
    return t.view(dtype)


class _Recorder:
    """A stand-in for the kernel's library: `bn_relu_launch` records the
    address of each call's mean vector, its (elements, channels) and x's
    dtype, and writes relu(((x - mean) * inv + bias) in x's dtype) with
    torch's CPU ops."""

    def __init__(self):
        self.calls = []
        self.scales = []  # the address of each call's inv

    def bn_relu_launch(self, x, mean, inv, bias, y, n, c, bf16, stream):
        dtype = torch.bfloat16 if bf16 else torch.float32
        self.calls.append((mean.value, n, c, dtype))
        self.scales.append(inv.value)
        rows = n // c
        out = torch.relu(((_values(x.value, n, dtype).view(rows, c).float()
                           - _values(mean.value, c, torch.float32))
                          * _values(inv.value, c, torch.float32)
                          + _values(bias.value, c, torch.float32)).to(dtype))
        _values(y.value, n, dtype).copy_(out.view(-1))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    """The card's path on the CPU: every tensor is on the card for
    `bn_relu.on_card`, and the library is a `_Recorder`. The counters
    start at 0 and are restored after."""
    rec = _Recorder()
    monkeypatch.setattr(bn_relu, "on_card", lambda x: True)
    monkeypatch.setattr(bn_relu.KERNEL, "_lib", rec)
    for name in ("launches", "bytes"):
        monkeypatch.setattr(bn_relu.KERNEL, name, 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    return rec


def _bn(width: int, dtype=torch.float32) -> BatchNorm:
    """A BatchNorm with running statistics, scale and shift away from
    their initial values."""
    g = torch.Generator().manual_seed(width)
    bn = BatchNorm(width)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(width, generator=g))
        bn.running_var.copy_(torch.rand(width, generator=g) + 0.1)
        bn.weight.copy_(torch.randn(width, generator=g))
        bn.bias.copy_(torch.randn(width, generator=g))
    return bn.to(dtype)


def _today(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """The sequence the call sites ran before the one entry: BatchNorm,
    then torch.relu."""
    return torch.relu(bn(x))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN payloads, the sign of zero)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def _special(width: int, dtype: torch.dtype) -> torch.Tensor:
    """(3, 5, width) values of dtype with a NaN, an inf and a -0."""
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(3, 5, width, generator=g) * 2).to(dtype)
    x[0, 0, 0] = float("nan")
    x[0, 1, 0] = float("inf")
    x[0, 2, 0] = -0.0
    return x


# name: (width, dtype, train mode, grad on, on the card); the card's
# training mode is run through the recording stand-in
FALLBACKS = {
    "train_mode": (8, torch.float32, True, True, True),
    "train_mode_no_grad": (8, torch.float32, True, False, True),
    "eval_grad_enabled": (8, torch.float32, False, True, False),
    "eval_float64": (8, torch.float64, False, False, False),
    "eval_bfloat16": (8, torch.bfloat16, False, False, False),
    "eval_width_not_a_multiple_of_4": (6, torch.float32, False, False,
                                       False),
}


@pytest.mark.parametrize("name", list(FALLBACKS))
def test_fallback_is_todays_sequence(name, request):
    """Training mode on the card, and every eval case on the CPU, run the
    torch sequence: the output, the running statistics and, where grad is
    on, the gradients bitwise those of BatchNorm then torch.relu; no
    launch."""
    width, dtype, train, grad, card = FALLBACKS[name]
    rec = request.getfixturevalue("recorder") if card else None
    x = _special(width, dtype)
    # float32 statistics and parameters, as a --bf16 model holds them, or
    # float64 throughout, as the parity tests run
    held = torch.float64 if dtype == torch.float64 else torch.float32
    entry, plain = _bn(width, held).train(train), _bn(width, held).train(train)
    xa, xb = x.clone().requires_grad_(grad), x.clone().requires_grad_(grad)
    launches = bn_relu.KERNEL.launches
    with torch.set_grad_enabled(grad):
        got = entry(xa, relu=True)
        want = _today(plain, xb)
    assert _same(got.detach(), want.detach())
    assert bn_relu.KERNEL.launches == launches
    assert rec is None or not rec.calls
    for a, b in zip(entry.buffers(), plain.buffers()):
        assert _same(a, b)
    if grad:
        (got * torch.arange(got.numel()).view_as(got)).sum().backward()
        (want * torch.arange(want.numel()).view_as(want)).sum().backward()
        assert _same(xa.grad, xb.grad)
        for a, b in zip(entry.parameters(), plain.parameters()):
            assert _same(a.grad, b.grad)


def test_cpu_without_the_stand_in_falls_back():
    """On the CPU, with no stand-in, an eval call with grad off is the
    plain sequence, float32, float64 and bfloat16, and launches
    nothing."""
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        bn = _bn(8, torch.float64 if dtype == torch.float64
                 else torch.float32).eval()
        x = torch.randn(4, 8).to(dtype)
        launches = bn_relu.KERNEL.launches
        with torch.inference_mode():
            assert _same(bn(x, relu=True), _today(bn, x))
        assert bn_relu.KERNEL.launches == launches


# name: (x, the BatchNorm's dtype, grad on, what the refusal names)
REFUSED = {
    "grad_enabled": (lambda: torch.randn(5, 8), torch.float32, True,
                     "grad is on"),
    "float64": (lambda: torch.randn(5, 8, dtype=torch.float64),
                torch.float64, False, "float64"),
    "width_not_a_multiple_of_4": (lambda: torch.randn(5, 6), torch.float32,
                                  False, "multiple of 4"),
    "not_contiguous": (lambda: torch.randn(8, 5).t(), torch.float32, False,
                       "contiguous"),
    "misaligned": (lambda: torch.randn(41)[1:].view(5, 8), torch.float32,
                   False, "aligned"),
    "bfloat16_misaligned": (
        lambda: torch.randn(43).to(torch.bfloat16)[3:].view(5, 8),
        torch.float32, False, "aligned"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_on_card_refuses_what_the_kernel_cannot_take(name, recorder):
    """On the card, an eval call the kernel cannot take raises ValueError
    naming why, and launches nothing: no path of the port gives it such
    a call, and none quietly runs the four passes instead."""
    make, held, grad, why = REFUSED[name]
    bn = _bn(make().shape[-1], held).eval()
    with torch.set_grad_enabled(grad):
        with pytest.raises(ValueError, match=why):
            bn(make(), relu=True)
    assert bn_relu.KERNEL.launches == 0 and not recorder.calls


@pytest.mark.parametrize("context", ["no_grad", "inference_mode"])
def test_kernel_path_and_counters(context, recorder):
    """An eval call with grad off on a float32 x of a width that is a
    multiple of 4 launches the kernel once: its bytes are x, the three
    vectors and y. `relu=False` is BatchNorm alone and counts nothing."""
    bn = _bn(12).eval()
    x = torch.randn(2, 7, 12)
    x[0, 0, :4] = torch.tensor([float("nan"), float("inf"),
                                -float("inf"), -0.0])
    want = _today(bn, x)
    plain = bn(x)
    launches, nbytes = bn_relu.KERNEL.launches, bn_relu.KERNEL.bytes
    with getattr(torch, context)():
        got = bn(x, relu=True)
        alone = bn(x)
    assert _same(got, want) and _same(alone, plain)
    assert recorder.calls == [(bn.running_mean.data_ptr(), x.numel(), 12,
                               torch.float32)]
    assert bn_relu.KERNEL.launches == launches + 1
    assert bn_relu.KERNEL.bytes == nbytes + 4 * (2 * x.numel() + 3 * 12)


@pytest.mark.parametrize("context", ["no_grad", "inference_mode"])
def test_kernel_path_bfloat16(context, recorder):
    """A bfloat16 x (``--bf16``) with float32 statistics takes the kernel
    too, flagged as bfloat16, with no widening copy ahead of it: y is
    bfloat16, bitwise BatchNorm then torch.relu, and the bytes are two
    an element of x and y and four of the vectors'."""
    bn = _bn(16).eval()
    x = _special(16, torch.bfloat16)
    want = _today(bn, x)
    launches, nbytes = bn_relu.KERNEL.launches, bn_relu.KERNEL.bytes
    with getattr(torch, context)():
        got = bn(x, relu=True)
    assert got.dtype == torch.bfloat16 and _same(got, want)
    assert recorder.calls == [(bn.running_mean.data_ptr(), x.numel(), 16,
                               torch.bfloat16)]
    assert bn_relu.KERNEL.launches == launches + 1
    assert bn_relu.KERNEL.bytes == nbytes + 2 * 2 * x.numel() + 4 * 3 * 16


def test_eval_scale_kept_while_its_tensors_hold(recorder):
    """The kernel's scale rsqrt(var + eps) * weight is computed once and
    read again by later eval calls; a change of the running variance
    (a copy, a train-mode forward), of the weight (an optimizer's
    in-place step, a load) computes it anew, and every output stays
    bitwise BatchNorm then torch.relu."""
    bn = _bn(8).eval()
    plain = _bn(8).eval()
    x = _special(8, torch.float32)[0]

    def call():
        with torch.inference_mode():
            got = bn(x, relu=True)
        plain.load_state_dict(bn.state_dict())
        assert _same(got, _today(plain, x))

    call()
    call()
    assert recorder.scales[0] == recorder.scales[1]
    changes = [
        lambda: bn.running_var.copy_(bn.running_var * 2),
        lambda: bn.weight.mul_(-0.5),
        lambda: bn.load_state_dict(_bn(8).state_dict()),
        lambda: bn.train()(torch.randn(16, 8)) is None or bn.eval(),
    ]
    for change in changes:
        before = bn._scale().clone()
        with torch.no_grad():
            change()
        call()
        assert not torch.equal(bn._scale(), before)
    assert bn_relu.KERNEL.launches == 2 + len(changes)


def test_takes_only_what_the_kernel_reads():
    """`refusal`: empty for grad off, float32 or bfloat16 x of a width
    that is a multiple of 4, contiguous and aligned, and float32 vectors
    of its width, contiguous and 16-byte aligned; a reason otherwise."""
    v = torch.zeros(8)
    x = torch.zeros(5, 8)
    with torch.no_grad():
        assert bn_relu.refusal(x, v, v, v) == ""
        assert bn_relu.refusal(x.to(torch.bfloat16), v, v, v) == ""
        assert bn_relu.refusal(torch.zeros(5, 4), *(torch.zeros(4),) * 3) \
            == ""
        for bad in (
                (x.double(), v, v, v), (x.half(), v, v, v),
                (x, v.double(), v, v), (x, v, v, v.to(torch.bfloat16)),
                (torch.zeros(8, 5).t(), v, v, v),
                (torch.zeros(41)[1:].view(5, 8), v, v, v),
                (x, torch.zeros(9)[1:], v, v), (x[:, :4], v[:4], v[:4], v[:4]),
                (x, torch.zeros(4), v, v),
                (torch.zeros(5, 6), *(torch.zeros(6),) * 3),
                (torch.zeros(()), v, v, v)):
            assert bn_relu.refusal(*bad), bad
    assert "grad" in bn_relu.refusal(x, v, v, v)


def _vote_flags(*extra):
    return votenet.add_common_flags(argparse.ArgumentParser()).parse_args(
        ["--num_point", str(N), "--num_target", str(K), *extra])


def _gf_flags(*extra):
    return groupfree.add_flags(argparse.ArgumentParser()).parse_args(
        ["--num_point", str(N), "--num_target", str(K),
         "--num_decoder_layers", "2", *extra])


# name: (the kind of chip_smoke.BN_PER_FORWARD, GroupFree3D's decoder
# layers)
MODELS = {
    "votenet:plain": ("plain", 0), "votenet:da": ("da", 0),
    "votenet:da_jitter": ("da_jitter", 0),
    "votenet_jitter2": ("da_jitter2", 0), "boxnet": ("boxnet", 0),
    "groupfree:plain": ("gf", 2), "groupfree:da": ("gf_da", 2),
    "groupfree:da_jitter": ("gf_da_jitter", 2),
    "votenet:random": ("random", 0), "votenet:da_random": ("da_random", 0),
    "cam": ("cam", 0), "votenet:plain:bf16": ("plain", 0),
    "groupfree:plain:bf16": ("gf", 2),
}


def _model(name, cfg):
    head = dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
                num_size_cluster=cfg.num_size_cluster,
                mean_size_arr=cfg.mean_size_arr)
    bf16 = ("--bf16", "--f32_tail", "2") if name.endswith(":bf16") else ()
    if name.startswith("votenet:"):
        kind = name.split(":")[1]
        random = ("--cluster_sampling", "random") if "random" in kind else ()
        return evaluate.build_model(_vote_flags(*random, *bf16), cfg,
                                    kind.replace("random", "").strip("_")
                                    or "plain")
    if name == "votenet_jitter2":
        return VoteNetDAJitter2(**head, input_feature_dim=1,
                                num_proposal=K)
    if name == "boxnet":
        return BoxNet(**head, input_feature_dim=1, num_proposal=K)
    if name == "cam":
        return Pointnet2BackboneCam(input_feature_dim=1)
    return groupfree.build_model(_gf_flags(*bf16), cfg, name.split(":")[1])


def _inputs(name, cfg):
    """The forward's arguments, made anew (a generator is drawn from)."""
    g = torch.Generator().manual_seed(0)
    width = 3 if name.startswith("groupfree") else 4
    args = [torch.rand(B, N, width, generator=g) * 4 - 2]
    if "jitter" in name:
        args += [torch.rand(B, 8, 3, generator=g) * 4 - 2,
                 torch.randint(0, cfg.num_class, (B, 8), generator=g)]
    if "random" in name:
        args.append(torch.Generator().manual_seed(5))
    return args


@pytest.mark.parametrize("name", list(MODELS))
def test_every_bn_relu_pair_takes_the_entry(name, recorder, monkeypatch):
    """The models' eval forwards with grad off: each BatchNorm that runs
    (the SA/FP stacks, voting, proposals, GF's KPS scorer, position
    embeddings and box heads, the DA and jitter heads) reaches the kernel
    once a call, in the dtype it computes in, as many a forward as
    `chip_smoke.bn_per_forward` counts for the model, and the outputs
    are bitwise those of the plain sequence."""
    cfg = get_config("scannet_md40")
    torch.manual_seed(0)
    model = _model(name, cfg).eval()
    ran = collections.Counter()
    by_mean = {}
    for module in model.modules():
        if isinstance(module, BatchNorm):
            by_mean[module.running_mean.data_ptr()] = module
            module.register_forward_hook(
                lambda m, a, out: ran.update([m.running_mean.data_ptr()]))
    with torch.inference_mode():
        got = model(*_inputs(name, cfg))
    fused = collections.Counter(mean for mean, *_ in recorder.calls)
    assert ran and fused == ran
    assert bn_relu.KERNEL.launches == len(recorder.calls)
    assert len(by_mean) == len(ran), "a BatchNorm of the model never ran"
    kind, layers = MODELS[name]
    assert len(recorder.calls) == chip_smoke.bn_per_forward(kind, layers)
    dtypes = {dtype for *_, dtype in recorder.calls}
    assert dtypes == ({torch.float32, torch.bfloat16}
                      if name.endswith(":bf16") else {torch.float32})
    monkeypatch.setattr(bn_relu, "on_card", lambda x: False)
    with torch.inference_mode():
        want = model(*_inputs(name, cfg))
    assert bn_relu.KERNEL.launches == len(recorder.calls)
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], torch.Tensor):
            assert _same(got[key], want[key]), key


def test_kernel_launch_span(recorder, tmp_path):
    """The host side of a launch runs inside ``kernel.bn_relu``."""
    bn = _bn(8).eval()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            bn(torch.randn(4, 8), relu=True)
            bn(torch.randn(4, 8))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert names == ["kernel.bn_relu"]


def test_kernel_source_rounds_each_step():
    """The library's one entry and its arithmetic: each step rounded by
    its own intrinsic (never an FMA), NaN passed through the ReLU, a
    bfloat16 result rounded to nearest even before it."""
    k = bn_relu.KERNEL
    assert k.source.name == "bn_relu.cu" and k.name == "bn_relu"
    assert list(k.signatures) == ["bn_relu_launch"]
    src = k.source.read_text()
    for token in ("__fsub_rn(", "__fmul_rn(", "__fadd_rn(", "isnan(",
                  "fmaxf(", "__float2bfloat16("):
        assert token in src, token
    assert "__fmaf" not in src and "fmaf(" not in src
