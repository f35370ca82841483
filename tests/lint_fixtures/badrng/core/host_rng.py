"""Seeded global-RNG violations of prng-discipline (never imported; parsed
only): the torch form of the reference's host-RNG ban."""
import random

import numpy as np
import torch


def seeded_globally(n):
    torch.manual_seed(0)  # FIRES: prng-discipline
    a = torch.rand(n)  # FIRES: prng-discipline
    b = torch.randn(n, 2)  # FIRES: prng-discipline
    c = torch.randperm(n)  # FIRES: prng-discipline
    return a, b, c


def in_place(t):
    return t.normal_()  # FIRES: prng-discipline


def host_samplers(n):
    np.random.seed(0)  # FIRES: prng-discipline
    u = np.random.rand(n)  # FIRES: prng-discipline
    r = random.random()  # FIRES: prng-discipline
    return u, r


def explicit_generators(n, seed):
    # the sanctioned spellings: every draw names its generator
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    sfc = np.random.Generator(np.random.SFC64(seed))
    a = torch.rand(n, generator=gen)
    b = torch.empty(n).normal_(generator=gen)
    return a, b, rng.uniform(size=n), sfc.integers(0, 3), random.Random(seed).random()
