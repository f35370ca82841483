"""``{"kind": "tiers", "n": n}``: ``n`` budgets at ``linspace(min price, sum
of prices, n)``, drawn in equal counts."""
import numpy as np


def levels(prices: np.ndarray, spec: dict) -> np.ndarray:
    return np.linspace(prices.min(), prices.sum(), int(spec["n"]))
