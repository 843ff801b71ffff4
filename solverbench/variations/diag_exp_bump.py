"""``diag_exp_bump``: solve k has A_k = A + alpha·diag(exp(−u_k)), u_k
uniform on [u_low, u_high) per unknown: the Jacobian of the Bratu problem
F(u) = A u − alpha·exp(−u) (PySolvers ``FDBratu2D``) at u_k.  A new host
CSR every solve, same pattern, new values; nothing frozen, so the solver
lowers it and builds its preconditioner anew.  Mix keys: ``alpha``,
``u_low``, ``u_high``."""
import numpy as np


class Variation:
    frozen = False

    def __init__(self, mix, A, A_dev, uniform):
        self.mix, self.A, self.A_dev = mix, A, A_dev
        self.uniform = uniform
        self.diag_pos = A.diag_positions()

    def next(self):
        """The bump alpha·exp(−u_k) on the device."""
        m = self.mix
        return m["alpha"] * (-self.uniform(m["u_low"], m["u_high"])).exp()

    def matvec(self, bump, x):
        """A_k x on the device (x of shape (n,) or (n, k))."""
        return self.A_dev @ x + (bump if x.dim() == 1 else bump[:, None]) * x

    def host(self, bump):
        """A_k's CSR: a copy of A's values with the bump added at the
        diagonal."""
        data = self.A.data.copy()
        data[self.diag_pos] += bump.cpu().numpy().astype(np.float64)
        return self.A.with_data(data)
