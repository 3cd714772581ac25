"""Inputs for the tests of the Kabsch kernel (csrc/kabsch.cu) and its plain
twin, shared by the CPU tests and the card tests (numpy and torch only, no
jax: the card's machine runs tests/test_torch_cuda.py without it).

Each case is (source, target, mask, weights) as float32 / bool numpy arrays
of shape (..., N, 3) and (..., N), from a fixed seed.
"""

from __future__ import annotations

import numpy as np
import torch

CASES = ("random", "one_point", "empty", "reflection", "rank1", "padded", "two_leading",
         "weighted", "large")


def rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


def _posed(rng, src, noise=0.01):
    """Each part of src under its own random pose, plus a little noise."""
    lead = src.shape[:-2]
    R = np.stack([rotation(rng) for _ in range(int(np.prod(lead)))]).reshape(*lead, 3, 3)
    t = rng.standard_normal((*lead, 1, 3))
    tgt = np.einsum("...ij,...nj->...ni", R, src) + t
    return (tgt + noise * rng.standard_normal(src.shape)).astype(np.float32)


def case(name: str):
    rng = np.random.default_rng(CASES.index(name) + 100)
    G, N = 3, 32
    weights = None
    if name in ("random", "large", "padded", "weighted", "two_leading"):
        shape = {"random": (4, 256), "large": (2, 32768), "padded": (4, 512),
                 "weighted": (4, 256), "two_leading": (2, 3, 128)}[name]
        src = rng.standard_normal((*shape, 3)).astype(np.float32)
        tgt = _posed(rng, src)
        mask = np.ones(shape, bool)
        if name == "padded":
            # valid prefixes of 0, 2, 300 and 512 points; the padding far away
            for g, n in enumerate((0, 2, 300, 512)):
                mask[g, n:] = False
            tgt = np.where(mask[..., None], tgt, 1e3).astype(np.float32)
        if name == "weighted":
            weights = rng.random(shape).astype(np.float32)
            mask = rng.random(shape) > 0.1
        return src, tgt, mask, weights
    # test_torch_procrustes.py's degenerate parts
    src = rng.standard_normal((G, N, 3)).astype(np.float32)
    tgt = src + rng.standard_normal((G, 1, 3)).astype(np.float32)
    mask = np.ones((G, N), bool)
    if name == "one_point":
        mask[1] = False
        mask[1, 5] = True
    elif name == "empty":
        mask[2] = False
    elif name == "reflection":  # the mirror image: the det fix gives det +1
        tgt = src * np.array([1.0, 1.0, -1.0], np.float32)
    elif name == "rank1":
        # collinear points on coordinate axes, every number exact in fp32:
        # H = (sum a^2) e_i e_j^T is rank 1 to the last bit, so the SVD takes
        # its rank-1 axis and the rotation about the line is the rule's own
        a = (np.arange(N) - (N - 1) / 2).astype(np.float32)  # sums to 0
        src, tgt = np.zeros((G, N, 3), np.float32), np.zeros((G, N, 3), np.float32)
        for g, (i, j, sign) in enumerate(((0, 1, 1.0), (2, 0, -1.0), (1, 1, 1.0))):
            src[g, :, i], tgt[g, :, j] = a, sign * a
        src += np.float32(0.5)
        tgt -= np.float32(2.0)
    return src, tgt, mask, weights


def torch_case(name: str, device="cpu"):
    return tuple(None if a is None else torch.from_numpy(a).to(device) for a in case(name))
