"""Synthetic procedural MNIST (offline container: no downloads).

Digits are rendered as anti-aliased seven-segment glyphs on a 28x28 grid
with random translation, scale jitter and pixel noise -- linearly separable
enough that LeNet reaches high accuracy in a few hundred steps, noisy
enough that hyperparameters matter (Katib has something to tune).
Deterministic given the seed.
"""
from __future__ import annotations

import numpy as np

# seven-segment layout:  segments (a top, b tr, c br, d bottom, e bl, f tl, g mid)
_SEGMENTS = {
    "a": ((4, 6), (4, 22)), "b": ((4, 22), (14, 22)), "c": ((14, 22), (24, 22)),
    "d": ((24, 6), (24, 22)), "e": ((14, 6), (24, 6)), "f": ((4, 6), (14, 6)),
    "g": ((14, 6), (14, 22)),
}
_DIGIT_SEGMENTS = {
    0: "abcdef", 1: "bc", 2: "abged", 3: "abgcd", 4: "fgbc",
    5: "afgcd", 6: "afgedc", 7: "abc", 8: "abcdefg", 9: "abcdfg",
}


def _draw_segment(img: np.ndarray, p0, p1, thickness: float):
    (r0, c0), (r1, c1) = p0, p1
    n = 24
    rr = np.linspace(r0, r1, n)
    cc = np.linspace(c0, c1, n)
    ys, xs = np.mgrid[0:28, 0:28]
    for r, c in zip(rr, cc):
        d2 = (ys - r) ** 2 + (xs - c) ** 2
        img += np.exp(-d2 / (2 * thickness ** 2))


def render_digit(digit: int, rng: np.random.Generator) -> np.ndarray:
    img = np.zeros((28, 28), np.float32)
    thick = rng.uniform(0.9, 1.6)
    dr, dc = rng.integers(-2, 3), rng.integers(-2, 3)
    scale = rng.uniform(0.85, 1.1)
    for seg in _DIGIT_SEGMENTS[digit]:
        (r0, c0), (r1, c1) = _SEGMENTS[seg]
        tr = lambda r, c: (14 + (r - 14) * scale + dr, 14 + (c - 14) * scale + dc)
        _draw_segment(img, tr(r0, c0), tr(r1, c1), thick)
    img = np.clip(img, 0, 1)
    img += rng.normal(0, 0.08, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def make_dataset(n: int, seed: int = 0):
    """Returns (images (N,28,28,1) f32, labels (N,) i32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    images = np.stack([render_digit(int(d), rng) for d in labels])
    return images[..., None].astype(np.float32), labels


class Batches:
    """Shuffled epoch iterator with host-side prefetch semantics."""

    def __init__(self, images, labels, batch_size: int, seed: int = 0,
                 drop_remainder: bool = True):
        self.images, self.labels = images, labels
        self.bs = batch_size
        self.rng = np.random.default_rng(seed)
        self.drop = drop_remainder

    def __iter__(self):
        idx = self.rng.permutation(len(self.labels))
        stop = len(idx) - (len(idx) % self.bs if self.drop else 0)
        for i in range(0, stop, self.bs):
            j = idx[i:i + self.bs]
            yield {"image": self.images[j], "label": self.labels[j]}
