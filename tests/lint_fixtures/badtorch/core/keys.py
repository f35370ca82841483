"""Seeded prng-discipline violations, badrepro's ``core/keys.py`` in torch
(never imported; parsed only)."""
from . import prng


def double_sample(key):
    a = prng.uniform(key, 4)
    b = prng.randint(key, 4, 0, 3)  # FIRES: prng-discipline
    return a + b


def sample_and_split(key):
    u = prng.uniform(key, 2)  # FIRES: prng-discipline
    k1, k2 = prng.split(key)
    return u, prng.uniform(k1, 1), prng.uniform(k2, 1)


def clean_fold(key, n):
    # the repo's CRN idiom: derive-many, consume-each-derived-once
    return prng.uniform(prng.fold_in(key, n), 1)
