"""Rule registry for the port's thriftlint.

Every rule module exposes ``RULE`` (the id used in CLI ``--rule`` filters
and ``# thriftlint: ignore[...]`` comments) and ``check(project)``.
"""
from . import f64_reduction, kernel_contract, prng_discipline, tf32_off

ALL_RULES = {
    mod.RULE: mod.check
    for mod in (prng_discipline, f64_reduction, kernel_contract, tf32_off)
}

__all__ = ["ALL_RULES"]
