"""``frozen``: every solve has the configuration's operator A, handed to
the solver once and frozen in it (matrix and preconditioner)."""


class Variation:
    frozen = True

    def __init__(self, mix, A, A_dev, uniform):
        self.A, self.A_dev = A, A_dev

    def next(self):
        """The next solve's draw: nothing to draw."""
        return None

    def matvec(self, state, x):
        """A x on the device."""
        return self.A_dev @ x

    def host(self, state):
        """A, the benchmark's CSR."""
        return self.A
