"""Seeded kernel-contract violations in the build (never imported)."""

NVCC_FLAGS = (  # FIRES: kernel-contract
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
    "--use_fast_math",  # FIRES: kernel-contract
)


def build():
    return {}


def entry(name):
    return build()[name]
