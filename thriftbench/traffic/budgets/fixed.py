"""``{"kind": "fixed", "usd": x}``: one budget of ``x`` USD."""
import numpy as np


def levels(prices: np.ndarray, spec: dict) -> np.ndarray:
    return np.asarray([float(spec["usd"])])
