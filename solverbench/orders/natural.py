"""``natural``: the unknowns as the operator file numbers them."""


def apply(A):
    return A
