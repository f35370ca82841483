"""Budget kinds, one module each, found by a mix's ``budget.kind`` name."""
