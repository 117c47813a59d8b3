"""Host-side replay buffer, the numpy copy of the JAX package's
``rtb/replay_buffer.py`` (src/rtb_utils/replay_buffer.py:9-66): deque of
(x, log_r, loss) with uniform or reward-softmax sampling; the ``reward``
strategy fills the first quarter of the batch with reward-softmax draws and
the rest with uniform draws (replay_buffer.py:50-58)."""
from __future__ import annotations

from collections import deque

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int = 1000, mode: str = "uniform", beta: float = 1.0, seed: int = 0):
        self.buf = deque(maxlen=capacity)
        self.mode = mode
        self.beta = beta
        self.rng = np.random.default_rng(seed)

    def add(self, x: np.ndarray, log_r: np.ndarray, loss: np.ndarray):
        """Store each element of a batch (host arrays; device tensors are
        copied to the host by the caller)."""
        for i in range(len(x)):
            self.buf.append((np.asarray(x[i]), float(np.asarray(log_r[i])), float(np.asarray(loss[i]))))

    def __len__(self):
        return len(self.buf)

    def _gather(self, idx):
        xs = np.stack([self.buf[i][0] for i in idx])
        lrs = np.array([self.buf[i][1] for i in idx], dtype=np.float32)
        return xs, lrs

    def sample_uniform(self, n: int):
        return self._gather(self.rng.integers(len(self.buf), size=n))

    def sample_reward(self, n: int):
        """Sample proportional to exp(beta * log_r) (replay_buffer.py:29-36)."""
        log_rs = np.array([b[1] for b in self.buf]) * self.beta
        p = np.exp(log_rs - log_rs.max())
        p = p / p.sum()
        return self._gather(self.rng.choice(len(self.buf), n, p=p))

    def sample(self, n: int):
        if not self.buf:
            raise ValueError("empty replay buffer")
        if self.mode == "uniform":
            return self.sample_uniform(n)
        if self.mode == "reward":
            xs, lrs = self.sample_reward(n)
            xu, lu = self.sample_uniform(n)
            k = n // 4  # 1/4 high-reward mix (replay_buffer.py:50-58)
            xs[k:], lrs[k:] = xu[k:], lu[k:]
            return xs, lrs
        raise ValueError(f"invalid replay-buffer sample strategy {self.mode!r}")
