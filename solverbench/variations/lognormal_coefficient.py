"""``lognormal_coefficient``: solve k has the P1 FEM stiffness of
−div(κ_k ∇u) on the fixed mesh and in the fixed order of the
configuration's operator (``operators/fem_p1_unstructured_2d.py``), with a
new log-normal coefficient per element, κ_k = exp(g_k(c_e)) at the
element's centroid c_e: a Monte Carlo sample of Darcy flow through a random
medium (Cliffe, Giles, Scheichl & Teckentrup, Comput. Visual. Sci. 14
(2011)).

g_k is a centred Gaussian field of exponential covariance
σ²·exp(−|x − y| / ℓ), drawn by ``modes`` random Fourier modes:
g(x) = σ·sqrt(2 / K)·Σ cos(ω_j·x + φ_j), with φ_j uniform on [0, 2π) and
ω_j from that covariance's spectral density, the bivariate Student t of
one degree of freedom scaled by 1/ℓ: ω = z / (ℓ·|u|), z ~ N(0, I₂),
u ~ N(0, 1).  All draws come from the traffic's seeded generator (normals
by Box–Muller from its uniforms).

Reassembly writes new values on A's pattern and order and nothing else:
an element-to-entry map, built once from a frozen copy of the operator's
mesh code (``mesh``, held to the operator file by ``solverbench/tests``),
gives for every entry of A the element terms that sum into it, padded to
a fixed width so that the sum runs in one fixed order (the same values
for the same seed).  At construction the map, with the operator's own
coefficient, must give A's values back.  Per solve the field, the
values and b = A_k x* are made on the device; ``host`` copies the values
into the benchmark's CSR.

Mix keys: ``mesh_seed`` and ``jitter`` (those of the configuration's
operator; its m is read from A), ``order`` (the configuration's order,
"rcm"), ``sigma2``, ``corr_len``, ``modes``."""
import math

import numpy as np

from solverbench.lib.csr import Csr

# elements summed per block when the field is evaluated at the centroids
_BLOCK = 1 << 18


def mesh(m: int, mesh_seed: int, jitter: float):
    """The operator's mesh, drawn as ``fem_p1_unstructured_2d.build`` draws
    it: (per-element local stiffness without the coefficient (E, 3, 3),
    centroids (E, 2), triangles (E, 3) in the unknowns' natural ids, -1
    for a boundary node, and the number of unknowns)."""
    rng = np.random.default_rng(mesh_seed)
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
    K0 = np.einsum("tkd,tld->tkl", grads, grads) * (0.5 * det)[:, None,
                                                               None]
    centroids = (p0 + p1 + p2) / 3.0
    new_id = np.full(n_nodes, -1, dtype=np.int64)
    ids = np.flatnonzero(interior)
    new_id[ids] = rng.permutation(len(ids))
    return K0, centroids, new_id[tris], len(ids)


def base_coefficient(centroids: np.ndarray) -> np.ndarray:
    """The operator file's own a = exp(0.8 sin 3πx sin 2πy) per element."""
    return np.exp(0.8 * np.sin(3 * np.pi * centroids[:, 0])
                  * np.sin(2 * np.pi * centroids[:, 1]))


def order_permutation(order: str, rows, cols, n: int) -> np.ndarray:
    """perm of the configuration's order, "rcm": row i of A is row perm[i]
    of the matrix in natural ids (a frozen copy of ``orders/rcm.py``'s)."""
    if order != "rcm":
        raise ValueError(f"no order {order!r} for the lognormal variation")
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    M = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    return reverse_cuthill_mckee(M, symmetric_mode=True)


def element_terms(tri_ids: np.ndarray):
    """(element, local row k, local column l, row id, column id) of every
    term of the assembly that joins two unknowns."""
    E = len(tri_ids)
    el = np.repeat(np.arange(E), 9)
    k = np.tile(np.repeat(np.arange(3), 3), E)
    l_ = np.tile(np.tile(np.arange(3), 3), E)
    r, c = tri_ids[el, k], tri_ids[el, l_]
    keep = (r >= 0) & (c >= 0)
    return el[keep], k[keep], l_[keep], r[keep], c[keep]


class Variation:
    frozen = False

    def __init__(self, mix, A: Csr, A_dev, uniform):
        import torch
        self.mix, self.A, self.A_dev, self.uniform = mix, A, A_dev, uniform
        self.device = A_dev.device
        m = math.isqrt(A.n) + 1
        if (m - 1) ** 2 != A.n:
            raise ValueError(f"n = {A.n} is not the unknowns of a mesh "
                             "with m cells a side")
        K0, centroids, tri_ids, n = mesh(m, mix["mesh_seed"],
                                         mix["jitter"])
        el, k, l_, r, c = element_terms(tri_ids)
        perm = order_permutation(mix["order"], r, c, n)
        iperm = np.empty(n, dtype=np.int64)
        iperm[perm] = np.arange(n)
        # entry index in A of each term, by the sorted (row, column) keys
        keys = A.rows() * A.n + A.indices
        term_keys = iperm[r] * A.n + iperm[c]
        pos = np.searchsorted(keys, term_keys)
        if not np.array_equal(keys[np.minimum(pos, A.nnz - 1)], term_keys):
            raise ValueError("the lognormal variation's mesh does not match "
                             "the operator's pattern")
        # each entry's terms, padded with the index of a zero term
        order = np.argsort(pos, kind="stable")
        counts = np.bincount(pos, minlength=A.nnz)
        slot = np.arange(len(pos)) - np.repeat(np.cumsum(counts) - counts,
                                               counts)
        table = np.full((A.nnz, int(counts.max())), len(pos), dtype=np.int64)
        table[pos[order], slot] = order
        weight = np.append(K0[el, k, l_], 0.0)
        base = (base_coefficient(centroids)[np.append(el, 0)]
                * weight)[table].sum(axis=1)
        if not np.allclose(base, A.data, rtol=1e-12,
                           atol=1e-12 * np.abs(A.data).max()):
            raise ValueError("the lognormal variation's map does not give "
                             "the operator's values back")

        self.table, self.weight, self.term_el, self.centroids = (
            torch.as_tensor(a, device=self.device)
            for a in (table, weight, np.append(el, 0), centroids))
        self.crow, self.col = A_dev.crow_indices(), A_dev.col_indices()

    def _normal(self, shape):
        u1 = 1.0 - self.uniform(shape=shape)            # (0, 1]
        u2 = self.uniform(shape=shape)
        return (-2.0 * u1.log()).sqrt() * (2.0 * math.pi * u2).cos()

    def next(self):
        """A_k's values on the device, in the order of A's entries."""
        import torch
        mix = self.mix
        K = mix["modes"]
        z = self._normal((K, 2))
        u = self._normal((K,))
        omega = z / (mix["corr_len"] * u.abs())[:, None]
        phase = self.uniform(0.0, 2.0 * math.pi, shape=(K,))
        amp = math.sqrt(mix["sigma2"] * 2.0 / K)
        g = torch.cat([amp * torch.cos(c @ omega.T + phase).sum(dim=1)
                       for c in self.centroids.split(_BLOCK)])
        terms = g.exp()[self.term_el] * self.weight
        return terms[self.table].sum(dim=1)

    def matvec(self, values, x):
        """A_k x on the device."""
        import warnings

        import torch
        with warnings.catch_warnings():
            # torch calls its sparse CSR support beta
            warnings.simplefilter("ignore", UserWarning)
            A_k = torch.sparse_csr_tensor(self.crow, self.col, values,
                                          size=self.A_dev.shape)
        return A_k @ x

    def host(self, values):
        """A_k's CSR: A's pattern with the values of this solve."""
        return self.A.with_data(values.cpu().numpy().astype(np.float64))

