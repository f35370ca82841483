"""Plain versions of the fixture's kernels (never imported; parsed only)."""


def toy_ref(x):
    return x * 2.0


def no_cpu_branch_ref(x):
    return x * 2.0


pair_ref = toy_ref
