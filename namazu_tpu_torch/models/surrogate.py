"""Learned reward surrogate: the port of ``namazu_tpu/models/surrogate.py``.

A small MLP predicts from schedule features whether a run reproduces the
bug. It is trained online on the search's labeled archive and re-ranks
the evolved population's top-k before a wall-clock run is spent on one.

The arithmetic is the reference's: K -> 128 -> 64 -> 1 with ReLU, logits
out; weighted binary cross-entropy over the real rows of a minibatch
padded to a fixed 256 rows with zero-weight rows; Adam at lr 1e-3 (the
update of ``optax.adam``: bias-corrected, eps 1e-8 outside the square
root); epoch order from ``np.random.RandomState(seed).permutation``, so
both packages visit the examples in the same order. Fresh weights follow
flax ``Dense``'s default initialisation (lecun-normal kernel, i.e. a
normal truncated at two standard deviations with std sqrt(1/fan_in) /
0.8796, and a zero bias), drawn from a ``torch.Generator`` seeded with
``seed``; they are not the reference's bits, so tests carry weights
across (``convert.surrogate_state_from_flax``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from namazu_tpu_torch.device import DeviceLike, resolve_device

# flax's variance_scaling: stddev of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class SurrogateMLP(nn.Module):
    """``dense_i`` is flax's ``Dense_i`` (weights transposed)."""

    def __init__(self, K: int, hidden: int = 128):
        super().__init__()
        self.dense_0 = nn.Linear(K, hidden)
        self.dense_1 = nn.Linear(hidden, hidden // 2)
        self.dense_2 = nn.Linear(hidden // 2, 1)

    def layers(self):
        return (self.dense_0, self.dense_1, self.dense_2)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax Dense defaults: lecun-normal kernel, zero bias."""
        with torch.no_grad():
            for lin in self.layers():
                std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=gen)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dense_0(x))
        x = F.relu(self.dense_1(x))
        return self.dense_2(x)[..., 0]  # logits


class RewardSurrogate:
    def __init__(self, K: int, hidden: int = 128, lr: float = 1e-3,
                 seed: int = 0, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.K = K
        self.model = SurrogateMLP(K, hidden)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.lr = lr
        self.opt = self._new_optimizer()
        self.steps = 0

    def _new_optimizer(self) -> torch.optim.Optimizer:
        return torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                betas=(0.9, 0.999), eps=1e-8)

    def load_state_dict(self, state: dict) -> None:
        """New weights; the optimizer restarts, as the reference's does
        when it restores a checkpoint."""
        self.model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()})
        self.opt = self._new_optimizer()

    def state_dict(self) -> dict:
        return {k: v.detach().cpu() for k, v in
                self.model.state_dict().items()}

    def _step(self, feats, labels, weight) -> float:
        logits = self.model(feats)
        per = F.binary_cross_entropy_with_logits(logits, labels,
                                                 reduction="none")
        loss = (per * weight).sum() / torch.clamp(weight.sum(), min=1.0)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.steps += 1
        return float(loss.detach())

    def train(self, feats: np.ndarray, labels: np.ndarray,
              epochs: int = 1, batch: int = 256, seed: int = 0) -> float:
        """Train on ``(feats [N, K], labels [N] in {0, 1})``; returns the
        last minibatch's loss."""
        n = len(feats)
        K = feats.shape[1]
        rng = np.random.RandomState(seed)
        loss = 0.0
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n, batch):
                idx = order[i:i + batch]
                nb = len(idx)
                f = np.zeros((batch, K), np.float32)
                f[:nb] = feats[idx]
                lb = np.zeros((batch,), np.float32)
                lb[:nb] = labels[idx]
                w = np.zeros((batch,), np.float32)
                w[:nb] = 1.0
                loss = self._step(*(torch.from_numpy(a).to(self.device)
                                    for a in (f, lb, w)))
        return loss

    def logits(self, feats: np.ndarray) -> np.ndarray:
        """The MLP's output (pre-sigmoid) per feature vector."""
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(feats, np.float32),
                                device=self.device)
            return self.model(x).cpu().numpy()

    def predict(self, feats: np.ndarray) -> np.ndarray:
        """P(reproduce bug) per feature vector."""
        return torch.sigmoid(torch.from_numpy(self.logits(feats))).numpy()

    def rerank(self, feats: np.ndarray, top: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Indices by descending probability, and the probabilities."""
        p = self.predict(feats)
        order = np.argsort(-p)
        if top is not None:
            order = order[:top]
        return order, p[order]
