"""The benchmark's operator files against the program's generators, at small
sizes, and the traffic's draws."""
import numpy as np
import pytest

from solverbench.lib import spec as S
from solverbench.lib.traffic import Traffic
from solverbench.reference import residual


def fd5(m):
    return S.build_operator({"kind": "fd5_laplacian_2d", "m": m})


def fem(m, seed, order="natural"):
    return S.build_operator({"kind": "fem_p1_unstructured_2d", "m": m,
                             "mesh_seed": seed, "order": order})


def _same(csr, H, exact=True):
    np.testing.assert_array_equal(csr.indptr, H.indptr)
    np.testing.assert_array_equal(csr.indices, H.indices)
    if exact:
        np.testing.assert_array_equal(csr.data, H.data)
    else:
        np.testing.assert_allclose(csr.data, H.data, rtol=1e-13,
                                   atol=1e-13 * np.abs(H.data).max())


@pytest.mark.parametrize("m", [1, 2, 7, 20])
def test_fd5_matches_the_program(m):
    from pysolvers_tpu_torch.problems import fd_laplacian_2d
    _same(fd5(m), fd_laplacian_2d(m))


@pytest.mark.parametrize("m,seed", [(5, 3), (17, 3), (24, 0)])
def test_fem_matches_the_program(m, seed):
    from pysolvers_tpu_torch.problems import fem_poisson_2d_unstructured
    _same(fem(m, seed), fem_poisson_2d_unstructured(m, seed=seed),
          exact=False)


def test_rcm_is_a_symmetric_permutation_that_narrows_the_band():
    A = fem(33, 3)
    P = fem(33, 3, order="rcm")
    assert P.nnz == A.nnz and P.n == A.n
    # the same spectrum's trace and the same multiset of values
    np.testing.assert_allclose(np.sort(P.data), np.sort(A.data))
    diag = lambda M: np.sort(M.data[M.diag_positions()])  # noqa: E731
    np.testing.assert_allclose(diag(P), diag(A))

    def band(M):
        return int(np.abs(M.indices.astype(np.int64) - M.rows()).max())
    assert band(P) < band(A) / 4
    assert (P.indices[1:][np.diff(P.rows()) == 0]
            > P.indices[:-1][np.diff(P.rows()) == 0]).all()


def test_build_reads_the_operator_entry():
    A = fd5(9)
    assert A.n == 81 and A.nnz == 5 * 81 - 4 * 9 and A.n_diagonals() == 5
    with pytest.raises(KeyError):
        S.build_operator({"kind": "nope", "m": 3})
    with pytest.raises(KeyError):
        S.build_operator({"kind": "fd5_laplacian_2d", "m": 3,
                          "order": "nope"})


def test_bump_is_the_bratu_jacobian():
    """A + alpha diag(exp(-u)) as the program's Bratu2D forms it."""
    import torch
    from pysolvers_tpu_torch.problems.bratu import Bratu2D
    mix = {"variation": "diag_exp_bump", "alpha": 0.5, "u_low": 0.0,
           "u_high": 1.0}
    A = fd5(12)
    t = Traffic(mix, A, 7, "cpu")
    assert not t.frozen
    x_star, bump, b = t.draw()
    u = -torch.log(bump / 0.5)
    J_host, _ = Bratu2D(12, alpha=0.5, device="cpu").eval_j(u)
    J = t.host(bump)
    np.testing.assert_array_equal(J.indptr, J_host.indptr)
    np.testing.assert_array_equal(J.indices, J_host.indices)
    np.testing.assert_allclose(J.data, J_host.data, rtol=1e-15)
    # the base operator is left as it was
    np.testing.assert_array_equal(A.data, fd5(12).data)
    Jx = J_host.matvec(x_star.numpy())
    np.testing.assert_allclose(b.numpy(), Jx, rtol=1e-12,
                               atol=1e-12 * np.abs(Jx).max())


def test_one_seed_one_sequence_every_seed_the_same_sizes():
    A = fd5(8)
    mix = {"variation": "frozen"}
    big = 2**31 + 12345
    a = [Traffic(mix, A, big, "cpu").draw() for _ in range(1)][0]
    b = Traffic(mix, A, big, "cpu").draw()
    c = Traffic(mix, A, big + 1, "cpu").draw()
    assert all(x.equal(y) for x, y in zip(a[::2], b[::2]))
    assert not a[0].equal(c[0]) and a[0].shape == c[0].shape
    assert a[1] is None
    with pytest.raises(KeyError):
        Traffic({"variation": "open_loop"}, A, 1, "cpu")


def test_columns_draw_a_block_of_right_hand_sides():
    """A mix with ``columns`` draws x* of shape (n, k), b = A_k x* column
    by column, for a frozen and for a changing operator."""
    A = fd5(6)
    for mix in ({"variation": "frozen", "columns": 3},
                {"variation": "diag_exp_bump", "alpha": 0.5, "u_low": 0.0,
                 "u_high": 1.0, "columns": 3}):
        t = Traffic(mix, A, 2**31 + 5, "cpu")
        x_star, state, b = t.draw()
        assert x_star.shape == b.shape == (A.n, 3)
        Ak = t.host(state)
        for j in range(3):
            ref = residual.csr_matvec(Ak.indptr, Ak.indices, Ak.data,
                                      x_star[:, j].numpy())
            np.testing.assert_allclose(b[:, j].numpy(), ref, rtol=1e-13)
