"""Faults planted under a cell's timed path, to show that ``correct``
catches them: each takes the session and the system's step (training) or
forward (serving) and returns the broken one.

* ``unchanged``: the optimizer's step does nothing, the state stays as it
  was (training);
* ``half_batch``: half of each batch's rows left out: a step takes the
  first half and the loss is their mean (training); a request's second
  half of scans is not served, its outputs zero (serving);
* ``altered``: one box centre of each request moved by 1 cm where the
  system produces it (serving).

Only one card is in every cell, so no exchange between cards can be
left out.
"""

from __future__ import annotations

import torch


def half_rows(batch: dict) -> dict:
    return {k: v[:v.shape[0] // 2] for k, v in batch.items()}


def train_unchanged(session, step):
    session.optimizer.step = lambda *args, **kwargs: None
    return step


def train_half_batch(session, step):
    return lambda batch: step(half_rows(batch))


def serve_half_batch(session, forward):
    def broken(points):
        outs = forward(points[:points.shape[0] // 2])
        return {k: torch.cat([v, torch.zeros_like(v)]) for k, v in
                outs.items()}
    return broken


def serve_altered(session, forward):
    def broken(points):
        outs = dict(forward(points))
        key = next(k for k in outs if k.endswith("center"))
        moved = outs[key].clone()
        moved[0, 0, 0] += 0.01
        outs[key] = moved
        return outs
    return broken


FAULTS = {"train": {"unchanged": train_unchanged,
                    "half_batch": train_half_batch},
          "serve": {"half_batch": serve_half_batch,
                    "altered": serve_altered}}
