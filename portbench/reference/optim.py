"""Adam and AdamW, plain: b1 0.9, b2 0.999, eps 1e-8, decoupled weight
decay (p <- p - lr * wd * p before the moment update), the bias
corrections of step t, and an optional clip of the gradients to a global
norm (scaled by max / norm where the norm reaches max, no epsilon)."""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, named_params, lr_of, weight_decay: float = 0.0,
                 clip: float | None = None):
        """`lr_of(name)` gives each parameter's learning rate."""
        self.params = dict(named_params)
        self.lr = {n: lr_of(n) for n in self.params}
        self.wd = weight_decay
        self.clip = clip
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.t = 0

    def clipped(self) -> dict:
        """The gradients as the update takes them."""
        grads = {n: p.grad for n, p in self.params.items()
                 if p.grad is not None}
        if self.clip is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if norm >= self.clip:
                grads = {n: g * (self.clip / norm) for n, g in grads.items()}
        return grads

    @torch.no_grad()
    def step(self) -> dict:
        """One update; returns the gradients it took."""
        grads = self.clipped()
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for n, g in grads.items():
            p, lr = self.params[n], self.lr[n]
            if self.wd:
                p.mul_(1 - lr * self.wd)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[n] / (1 - b1 ** self.t)
            v_hat = self.v[n] / (1 - b2 ** self.t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
        return grads


class Trainer:
    """A train step of the reference: the model in train mode, `loss(batch)`
    backward, then :class:`Adam`. :meth:`load` puts a state in place
    (parameters, moments, step count, dropout generator), so that a step
    can be taken from the system's state."""

    def __init__(self, model, loss, lr_of, weight_decay: float = 0.0,
                 clip: float | None = None, generator=None):
        self.model = model
        self.loss = loss
        self.opt = Adam(model.named_parameters(), lr_of, weight_decay, clip)
        self.generator = generator

    @torch.no_grad()
    def load(self, params: dict, m: dict, v: dict, t: int,
             generator_state=None):
        for n, p in self.opt.params.items():
            p.copy_(params[n])
            self.opt.m[n].copy_(m[n])
            self.opt.v[n].copy_(v[n])
        self.opt.t = t
        if generator_state is not None:
            self.generator.set_state(generator_state)

    def step(self, batch):
        """(loss, the gradients the update took)."""
        self.model.train()
        loss = self.loss(batch)
        for p in self.model.parameters():
            p.grad = None
        loss.backward()
        return loss.detach(), self.opt.step()
