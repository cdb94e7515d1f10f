"""The work a step's point-cloud kernels need: operations and bytes per
call, from each call's shapes and, for the ball query and the grouping,
from what the call returned (the tests the data needs, the distinct rows
gathered). The least time a call can take on the card is the larger of
its operations over the f32 peak and its bytes over the memory peak.

* FPS: 10 f32 operations a point a sample (3 sub, 3 mul, 2 add, a min, a
  compare); bytes: the points read once, the indices written.
* Stratified ball query: 9 operations a test the data needs (each slot
  tests its bucket up to its first hit, a slot with no hit the whole
  bucket); bytes: points and centres read, indices and flags written.
* Stratified grouping with the localize step, forward: 6 operations a
  slot (subtract, divide, for 3 coordinates); bytes: indices and flags,
  the distinct rows gathered, the centres, the output. Backward, where an
  input takes a gradient: one add a value of the gradients taken; bytes:
  the output's gradient read, indices and flags, the dense gradients
  written (and the centres' where they take one).

:class:`WorkLog` wraps the system's op entry points while one step or
request runs and records each call's work; it is for a counting pass
outside the measured window, never inside it.
"""

from __future__ import annotations

import torch

FPS_OPS_PER_POINT = 10
BQ_OPS_PER_TEST = 9


def fps(b, n, npoint):
    return (FPS_OPS_PER_POINT * b * (npoint - 1) * n,
            b * n * 12 + b * npoint * 4)


def ball_query(b, n, m, s, tests):
    return BQ_OPS_PER_TEST * tests, b * n * 12 + b * m * 12 + b * m * s * 5


def group_forward(b, m, s, c, rows):
    return (2 * 3 * b * m * s,
            b * m * s * 5 + rows * (3 + c) * 4 + b * m * 12
            + b * m * s * (3 + c) * 4)


def group_backward(b, n, m, s, width, centres):
    return (b * m * s * width,
            b * m * s * width * 4 + b * m * s * 5 + b * n * width * 4
            + (b * m * 12 if centres else 0))


def tests_needed(idx, hit, n, bucket):
    """Distance tests a stratified query needs: each slot scans its bucket
    up to its first hit, or all of it."""
    s = idx.shape[-1]
    base = torch.arange(s, device=idx.device) * bucket
    span = torch.clamp(n - base, 0, bucket)
    return int(torch.where(hit, idx - base + 1, span).sum().item())


def distinct_rows(idx, n):
    b = idx.shape[0]
    flat = idx.long() + torch.arange(b, device=idx.device)[:, None, None] * n
    return torch.unique(flat).numel()


class WorkLog:
    """``with WorkLog() as log``: ``log.calls`` gets (kind, operations,
    bytes) for each FPS, ball query and grouping call of the system run
    inside, and a grouping's backward where its inputs take a gradient
    (kinds ``fps``, ``query``, ``group``, ``group_backward``)."""

    def __enter__(self):
        import importlib

        from backtoreality_tpu_torch import ops

        # the module (the package's attribute of that name is the function)
        bq = importlib.import_module("backtoreality_tpu_torch.ops.ball_query")

        self.calls = []
        self.units = 0
        self._ops = ops
        self._saved = {k: getattr(ops, k) for k in (
            "furthest_point_sample", "ball_query_stratified",
            "group_localize_stratified")}
        fps_fn, query_fn, group_fn = self._saved.values()

        def fps_logged(xyz, npoint, candidates=None):
            n = xyz.shape[1] if candidates is None else min(candidates,
                                                            xyz.shape[1])
            self.calls.append(("fps", *fps(xyz.shape[0], n, npoint)))
            return fps_fn(xyz, npoint, candidates)

        def query_logged(xyz, new_xyz, radius, nsample, return_hit=False):
            idx, hit = query_fn(xyz, new_xyz, radius, nsample,
                                return_hit=True)
            b, n = xyz.shape[:2]
            m = new_xyz.shape[1]
            tests = tests_needed(idx, hit, n, bq._bucket_size(n, nsample))
            self.calls.append(("query", *ball_query(b, n, m, nsample,
                                                    tests)))
            return (idx, hit) if return_hit else idx

        def group_logged(xyz, features, new_xyz, idx, hit, radius):
            b, n = xyz.shape[:2]
            m, s = idx.shape[1:]
            c = 0 if features is None else features.shape[-1]
            self.calls.append(("group", *group_forward(
                b, m, s, c, distinct_rows(idx, n))))
            if torch.is_grad_enabled():
                width = ((3 if xyz.requires_grad else 0)
                         + (c if features is not None
                            and features.requires_grad else 0))
                if width or new_xyz.requires_grad:
                    self.calls.append(("group_backward", *group_backward(
                        b, n, m, s, width, new_xyz.requires_grad)))
            return group_fn(xyz, features, new_xyz, idx, hit, radius)

        ops.furthest_point_sample = fps_logged
        ops.ball_query_stratified = query_logged
        ops.group_localize_stratified = group_logged
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._ops, name, fn)
        return False

    def bound_ms(self, kinds, peaks) -> float:
        """The least milliseconds a unit's calls of `kinds` take at
        `peaks` (f32 FLOP/s, bytes/s), over the `units` logged."""
        total = sum(max(ops / peaks[0], nbytes / peaks[1])
                    for kind, ops, nbytes in self.calls if kind in kinds)
        return total * 1e3 / self.units
