"""Synthetic HD datasets matching the paper's evaluation suite.

The paper evaluates on Gaussian blobs (overlapping / disjoint), COIL-20
(ring manifolds), an S-curve, MNIST and single-cell data.  Offline we
generate structured stand-ins with the same geometry: blobs with
controllable separation, ring manifolds ('coil'), an S-curve with optional
unbalanced sampling (paper Fig. 1), and a hierarchical mixture ('cells')
mimicking the cluster-of-clusters structure of transcriptomics data.
"""
from __future__ import annotations

import numpy as np


def blobs(n: int = 2000, dim: int = 32, n_centers: int = 5,
          center_std: float = 1.0, blob_std: float = 1.0, seed: int = 0):
    """Gaussian blobs; 'overlapping' = large blob_std, small center_std."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, center_std, (n_centers, dim))
    labels = rng.integers(0, n_centers, n)
    X = centers[labels] + rng.normal(0.0, blob_std, (n, dim))
    return X.astype(np.float32), labels.astype(np.int32)


def disjoint_blobs(n: int = 30000, dim: int = 32, n_centers: int = 1000,
                   seed: int = 0):
    """Paper Fig. 7 'Disjointed': many tiny well-separated clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 10.0, (n_centers, dim))
    labels = np.resize(np.repeat(np.arange(n_centers),
                                 max(1, -(-n // n_centers))), n)
    X = centers[labels] + rng.normal(0.0, 0.05, (n, dim))
    return X.astype(np.float32), labels.astype(np.int32)


def s_curve(n: int = 2000, noise: float = 0.0, unbalanced: bool = False,
            seed: int = 0):
    """3-D 'S' sheet (paper Fig. 1); unbalanced halves optional."""
    rng = np.random.default_rng(seed)
    if unbalanced:
        n_top = int(n * 10 / 11)
        t = np.concatenate([rng.uniform(0.0, 0.5, n - n_top),
                            rng.uniform(0.5, 1.0, n_top)])
    else:
        t = rng.uniform(0.0, 1.0, n)
    theta = 3.0 * np.pi * (t - 0.5)
    y = rng.uniform(0.0, 2.0, n)
    X = np.stack([np.sin(theta), y, np.sign(theta) * (np.cos(theta) - 1.0)],
                 axis=1)
    X += rng.normal(0.0, noise, X.shape)
    labels = (t > 0.5).astype(np.int32)
    return X.astype(np.float32), labels


def coil_rings(n_objects: int = 20, n_per_object: int = 72, dim: int = 32,
               radius: float = 1.0, separation: float = 6.0, seed: int = 0):
    """COIL-20 stand-in: ring manifolds in random 2-D subspaces of R^dim."""
    rng = np.random.default_rng(seed)
    xs, labels = [], []
    for o in range(n_objects):
        basis = np.linalg.qr(rng.normal(size=(dim, 2)))[0]
        center = rng.normal(0.0, separation, dim)
        ang = np.linspace(0.0, 2 * np.pi, n_per_object, endpoint=False)
        ring = np.stack([np.cos(ang), np.sin(ang)], 1) * radius
        xs.append(center + ring @ basis.T)
        labels.append(np.full(n_per_object, o))
    X = np.concatenate(xs).astype(np.float32)
    return X, np.concatenate(labels).astype(np.int32)


def hierarchical_cells(n: int = 4000, dim: int = 50, n_major: int = 4,
                       minors_per_major: int = 4, seed: int = 0):
    """Transcriptomics stand-in: major types -> sub-types -> cells."""
    rng = np.random.default_rng(seed)
    Xs, major_l, minor_l = [], [], []
    per = n // (n_major * minors_per_major)
    for a in range(n_major):
        major = rng.normal(0.0, 8.0, dim)
        for b in range(minors_per_major):
            minor = major + rng.normal(0.0, 2.0, dim)
            Xs.append(minor + rng.normal(0.0, 0.5, (per, dim)))
            major_l += [a] * per
            minor_l += [a * minors_per_major + b] * per
    X = np.concatenate(Xs).astype(np.float32)
    return (X, np.array(major_l, np.int32), np.array(minor_l, np.int32))


def mnist_like(n: int = 4000, dim: int = 64, n_classes: int = 10,
               manifold_dim: int = 3, seed: int = 0):
    """MNIST stand-in: per-class smooth low-dim manifolds in R^dim."""
    rng = np.random.default_rng(seed)
    Xs, labels = [], []
    per = n // n_classes
    for c in range(n_classes):
        basis = np.linalg.qr(rng.normal(size=(dim, manifold_dim)))[0]
        center = rng.normal(0.0, 6.0, dim)
        t = rng.uniform(-1.0, 1.0, (per, manifold_dim))
        Xs.append(center + (t ** 3) @ basis.T * 3.0
                  + rng.normal(0.0, 0.2, (per, dim)))
        labels += [c] * per
    return (np.concatenate(Xs).astype(np.float32),
            np.array(labels, np.int32))
