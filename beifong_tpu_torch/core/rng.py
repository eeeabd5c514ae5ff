"""Counter-based sample streams (counterpart of `beifong_tpu/core/rng.py`).

The JAX package folds threefry keys per (sample, lane, dimension); the
port draws Philox4x32-10, the generator of its receive kernel, keyed
explicitly: the uniform of lane `l`, pass `p` and dimension `k` under seed
`s` is word k % 4 of Philox4x32-10(counter (l, p, k // 4, 0), key (s mod
2^32, s >> 32)), its top 24 bits scaled by 2^-24.  It is computed with
int64 tensor ops, so one seed gives one stream on the CPU and on a card.
The streams differ from the JAX package's by design; tests that compare
the two packages hand both the same uniforms.
"""

from __future__ import annotations

import dataclasses

import torch

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
GROUPS = 4   # Philox counter blocks (4 dimensions each) drawn per batch


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a < 2^32 and b an int64 tensor
    of values < 2^32, without leaving int64."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    mid = (p0 >> 16) + p1
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words: returns the
    four output words for counter (c0, c1, c2, c3) and key (k0, k1)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & MASK32
        k1 = (k1 + _PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def word_to_uniform(w: torch.Tensor) -> torch.Tensor:
    """Top 24 bits of a 32-bit word as a float32 in [0, 1)."""
    return (w >> 8).to(torch.float32) * (1.0 / float(1 << 24))


@dataclasses.dataclass(frozen=True)
class SampleStream:
    """A per-lane stream of uniforms consumed by dimension, as the JAX
    package's `SampleStream`: `next_1d` / `next_2d` return the draw and
    the stream advanced by one / two dimensions.  Streams derived from one
    `make` share the Philox words of the groups they have drawn."""

    seed: int
    pass_idx: int
    lane: torch.Tensor          # (n,) int64 lane ids
    dim: int = 0
    words: dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def make(seed: int, n_lanes: int, pass_idx: int,
             device=None) -> "SampleStream":
        lane = torch.arange(n_lanes, dtype=torch.int64, device=device)
        return SampleStream(seed=int(seed), pass_idx=int(pass_idx),
                            lane=lane)

    def uniform(self, k: int) -> torch.Tensor:
        """(n,) float32 uniforms of dimension k."""
        g, w = divmod(k, 4)
        if g not in self.words:
            # GROUPS counter blocks in one batch of tensor ops
            lane = self.lane[None, :]
            blocks = torch.arange(g, g + GROUPS, dtype=torch.int64,
                                  device=lane.device)[:, None]
            out = philox4x32_10(
                lane & MASK32,
                torch.full_like(lane, self.pass_idx & MASK32),
                blocks.expand(GROUPS, lane.shape[1]), torch.zeros_like(lane),
                self.seed & MASK32, (self.seed >> 32) & MASK32)
            for i in range(GROUPS):
                self.words[g + i] = tuple(word[i] for word in out)
        return word_to_uniform(self.words[g][w])

    def next_1d(self):
        return self.uniform(self.dim), dataclasses.replace(
            self, dim=self.dim + 1)

    def next_2d(self):
        u = torch.stack([self.uniform(self.dim), self.uniform(self.dim + 1)],
                        dim=-1)
        return u, dataclasses.replace(self, dim=self.dim + 2)


def make_stream(kind: str, seed: int, n_lanes: int, pass_idx: int,
                device=None) -> SampleStream:
    """Sampler factory: 'independent' only so far."""
    if kind != 'independent':
        raise NotImplementedError(
            f"sampler {kind!r}: the stratified, multijitter, halton, "
            "ldsampler and orthogonal samplers are ROADMAP A2")
    return SampleStream.make(seed, n_lanes, pass_idx, device=device)
