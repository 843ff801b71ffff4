"""``fem_p1_unstructured_2d``: the P1 stiffness of −div(a∇u) on a jittered
triangulation with m cells a side, each cell split along a random
diagonal, a = exp(0.8 sin 3πx sin 2πy) per element, boundary nodes
eliminated and the unknowns shuffled, all drawn from ``mesh_seed``.  A
frozen copy of the program's ``problems.fem_poisson_2d_unstructured``
(held to it at small sizes by ``solverbench/tests``).  Entry keys: ``m``,
``mesh_seed``, ``jitter`` (default 0.22, in cell widths)."""
import numpy as np

from solverbench.lib.csr import Csr, from_coo


def build(op: dict) -> Csr:
    m, jitter = op["m"], op.get("jitter", 0.22)
    rng = np.random.default_rng(op["mesh_seed"])
    h = 1.0 / m
    xi = np.linspace(0.0, 1.0, m + 1)
    X, Y = np.meshgrid(xi, xi, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    n_nodes = (m + 1) * (m + 1)
    interior = ((X > 0) & (X < 1) & (Y > 0) & (Y < 1)).ravel()
    pert = rng.uniform(-jitter * h, jitter * h, size=(n_nodes, 2))
    pts = pts + np.where(interior[:, None], pert, 0.0)
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    v00 = ii * (m + 1) + jj
    v10 = (ii + 1) * (m + 1) + jj
    v01 = ii * (m + 1) + (jj + 1)
    v11 = (ii + 1) * (m + 1) + (jj + 1)
    diag = rng.integers(0, 2, size=m * m).astype(bool)
    tris = np.where(
        diag[:, None, None],
        np.stack([np.stack([v00, v10, v01], 1),
                  np.stack([v10, v11, v01], 1)], 1),
        np.stack([np.stack([v00, v10, v11], 1),
                  np.stack([v00, v11, v01], 1)], 1)).reshape(-1, 3)
    p0, p1, p2 = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    det = ((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
           - (p2[:, 0] - p0[:, 0]) * (p1[:, 1] - p0[:, 1]))
    if not (det > 0).all():
        raise ValueError("degenerate triangle: lower the jitter")
    grads = np.stack([p2 - p1, p0 - p2, p1 - p0], axis=1)
    grads = grads[:, :, ::-1] * np.array([1.0, -1.0]) / det[:, None, None]
    c = (p0 + p1 + p2) / 3.0
    a_e = np.exp(0.8 * np.sin(3 * np.pi * c[:, 0])
                 * np.sin(2 * np.pi * c[:, 1]))
    K = np.einsum("tkd,tld->tkl", grads, grads) * (a_e * 0.5 * det)[:, None,
                                                                    None]
    rows = np.repeat(tris, 3, axis=1).ravel()
    cols = np.tile(tris, (1, 3)).ravel()
    vals = K.transpose(0, 2, 1).ravel()
    keep = interior[rows] & interior[cols]
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    new_id = np.full(n_nodes, -1, dtype=np.int64)
    ids = np.flatnonzero(interior)
    new_id[ids] = rng.permutation(len(ids))
    return from_coo(new_id[rows], new_id[cols], vals, len(ids))
